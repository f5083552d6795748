"""Training loop driver (port of ``mobilenet_yolo_tpu/train/loop.py``).

The counterpart of reference train.py:45-331 (``main``/``train``/``test``):
epoch loop with the step-decay + warm-up LR schedule, per-batch train step
with running meters, alternate-epoch mAP evaluation with the val_conf
feedback controller, checkpointing (latest + best, ``train/checkpoints.py``),
TSV logging, TensorBoard scalars and HPO report hooks.

The steps run eagerly on ``device`` (the card unless the caller asks for
the CPU) and update the model, its BatchNorm statistics, the optimizer
and the EMA average in place.

Under a ``mesh`` (``parallel/mesh.py``; one process a rank) every rank runs
this loop in lockstep: the train batches are this rank's rows, the steps
reduce over the mesh's data group, the large layers are split over its
model group when the model axis is above 1 (``parallel/sharding.py``),
evaluation runs the sharded predict on the host-complete eval batches, and
rank 0 alone prints, logs and writes TensorBoard events and checkpoints.
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from mobilenet_yolo_tpu_torch.data.pipeline import batch_to_device
from mobilenet_yolo_tpu_torch.eval.detector import make_predict_fn
from mobilenet_yolo_tpu_torch.eval.evaluator import evaluate_detection
from mobilenet_yolo_tpu_torch.parallel.mesh import (is_primary, rank_device, shard_batch,
                                                    sync_processes)
from mobilenet_yolo_tpu_torch.parallel.sharding import shard_over_model_axis
from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager
from mobilenet_yolo_tpu_torch.train.hpo import NoOpReport, ReportHook
from mobilenet_yolo_tpu_torch.train.schedule import learning_rate_for_epoch
from mobilenet_yolo_tpu_torch.train.state import create_train_state
from mobilenet_yolo_tpu_torch.train.step import (GEOMETRY_BATCH_KEYS, make_geometry_train_step,
                                                 make_train_step)
from mobilenet_yolo_tpu_torch.utils.logger import Logger
from mobilenet_yolo_tpu_torch.utils.meters import MeterDict

# the JAX loop's noise key, PRNGKey(17) (loop.py:161)
AUG_KEY = 17


def aug_seed(epoch: int, batch: int) -> int:
    """The geometry step's noise seed for batch ``batch`` of ``epoch``.

    JAX folds ``epoch * 100003 + batch`` into ``PRNGKey(17)``
    (``loop.py:294``); the port's step takes an int seed in int32 range,
    ``(17 * 1000003 + epoch * 100003 + batch) mod 2^31``. It depends on
    the pair alone, so a run resumed mid-epoch draws the noise the
    uninterrupted run drew. The two packages' noise streams differ by
    design (ROADMAP Queue 3)."""
    return (AUG_KEY * 1_000_003 + epoch * 100_003 + batch) % 2 ** 31


class TensorBoardWriter:
    """Scalar writer (reference train.py:49-51,200-217).

    Writes real TF event files through the dependency-free
    ``utils/tb_writer.py`` encoder — no tensorflow import and no silent
    scalar dropping when TF is absent.
    """

    def __init__(self, logdir: Optional[str]):
        self._writer = None
        if logdir:
            from mobilenet_yolo_tpu_torch.utils.tb_writer import EventFileWriter
            self._writer = EventFileWriter(logdir)

    def scalar(self, tag: str, value: float, step: int):
        if self._writer is None:
            return
        self._writer.scalar(tag, float(value), step)
        self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()


@dataclass
class TrainerConfig:
    epochs: int = 300
    learning_rate: float = 7e-4
    weight_decay: float = 4e-4
    schedule: tuple = (100, 170, 240)
    warm_up: tuple = ()
    checkpoint_dir: str = "checkpoint"
    eval_every: int = 2            # odd epochs evaluate (train.py:189,203)
    log_suffix_every: int = 10
    # mid-epoch checkpoint cadence in batches (0 = per-epoch only, the
    # reference's granularity). When on, checkpoints carry (epoch,
    # batch_idx) and resume fast-forwards the Loader to the exact batch;
    # step ids become epoch*1e6+batch so they stay monotonic.
    checkpoint_every_batches: int = 0
    tensorboard_dir: Optional[str] = None
    max_gt: int = 90
    # NMS top-K horizon for evaluation. The reference's ragged pipeline has
    # no cap (utils/box.py:11-31); early-training eval at the val_conf floor
    # (0.01) passes many hundreds of candidates per image, and clipping them
    # skews both mAP and the controller's pred-box count. 512 covers the
    # post-gate candidate count in practice; override via model yaml
    # ``nms_top_k`` for very dense scenes.
    nms_top_k: int = 512
    # exponential-moving-average decay for the eval weights (0 = off, the
    # reference's behavior; 0.999-0.9999 typical). When on, the train step
    # maintains the average and evaluation/best-model selection use it
    # (train/state.py). Beyond-reference training stabilizer.
    ema_decay: float = 0.0
    # capture a torch.profiler trace of this many train steps (after the
    # first two batches) into <tensorboard_dir or checkpoint_dir>/profile,
    # as a Chrome trace (chrome://tracing, Perfetto) that holds the step's
    # myt: spans beside the card's work. 0 = off.
    profile_steps: int = 0


class Trainer:
    def __init__(self, model: torch.nn.Module, model_cfg: dict, classes_name: list[str],
                 cfg: TrainerConfig, segmentation: bool = False, mesh=None,
                 report: ReportHook | None = None, verbose: bool = True,
                 device_normalize: bool = False,
                 device_pixel_aug: bool = False,
                 device_geometry: bool = False, *,
                 device: str | torch.device = "cuda",
                 dtype: torch.dtype | None = None):
        """``model`` is moved to ``device``, the card unless the caller
        asks for the CPU; without a card the default raises. ``dtype``
        bf16 runs the steps and predict under autocast (``--bf16``). The
        geometry step augments through the ``aug_compose`` kernel on the
        card and through its plain ops on the CPU.

        device_normalize: loaders emit raw [0,255] uint8 batches
        (Loader(output_uint8=True)) and the step/predict apply the config's
        mean/std on the device. device_pixel_aug: additionally run the
        photometric color jitter on the device in host-planned per-image op
        order (Loader._collate's jitter_op / jitter_factor); pair with a
        host dataset built with apply_photometric=False. device_geometry:
        batches arrive as staged sources + compose parameters
        (Loader(device_geometry=True)) and the step runs the whole
        augmentation on the device (make_geometry_train_step).

        mesh: this process is one rank of it (``parallel.mesh.create_mesh``);
        ``device`` ``cuda`` then means this rank's card
        (``parallel.mesh.rank_device``)."""
        self.device = rank_device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the Trainer runs on the card by default and no CUDA device is "
                               "available; pass device='cpu' to train on the CPU")
        self.model = model.to(self.device)
        self.model_cfg = model_cfg
        self.classes_name = classes_name
        self.cfg = cfg
        self.segmentation = segmentation
        self.mesh = mesh
        self.report = report or NoOpReport()
        # prints, log.txt and TensorBoard events come from rank 0 only: the
        # metrics are the same on every rank
        self._primary = is_primary()
        self.verbose = verbose and self._primary
        self._ema_decay = cfg.ema_decay if cfg.ema_decay > 0 else None
        # predict first: it puts the model in channels_last memory, and the
        # optimizer then holds the parameters in the layout the steps use
        self.predict = make_predict_fn(model, model_cfg, top_k=cfg.nms_top_k,
                                       normalize=device_normalize, dtype=dtype, mesh=mesh)
        self.state = create_train_state(model, learning_rate=cfg.learning_rate,
                                        weight_decay=cfg.weight_decay, ema=cfg.ema_decay > 0)
        if mesh is not None:
            # tensor parallelism (a model axis above 1): split the large
            # output channels (and their moments and average) over the model
            # axis; the steps broadcast the state over each data group at
            # their first call
            shard_over_model_axis(self.state, mesh)
        self.device_pixel_aug = device_pixel_aug
        self.device_geometry = device_geometry
        if device_geometry:
            self.train_step = make_geometry_train_step(
                model, model_cfg, segmentation=segmentation, ema_decay=self._ema_decay,
                dtype=dtype, mesh=mesh)
        else:
            self.train_step = make_train_step(
                model, model_cfg, segmentation=segmentation, normalize=device_normalize,
                pixel_aug=device_pixel_aug, ema_decay=self._ema_decay, dtype=dtype, mesh=mesh)
        self.ckpt = CheckpointManager(cfg.checkpoint_dir)
        self.tb = TensorBoardWriter(cfg.tensorboard_dir if self._primary else None)
        self.logger = None
        self.best_acc = 0.0
        self._profiled = False
        self._profiler = None

    @property
    def _trace_open(self) -> bool:
        return self._profiler is not None

    def _profile_dir(self) -> str:
        return os.path.join(self.cfg.tensorboard_dir or self.cfg.checkpoint_dir, "profile")

    # ------------------------------------------------------------- resume --
    def maybe_resume(self) -> bool:
        # flexible: survives --ema-decay toggled between save and resume
        restored = self.ckpt.restore_latest_flexible(self.state)
        if restored is None:
            return False
        self.state = restored
        self.best_acc = float(restored.best_acc)
        b = int(restored.batch_idx)
        self._log(f"resumed from epoch {int(restored.epoch)}"
                  + (f" batch {b}" if b else ""))
        return True

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    def _ckpt_step(self, epoch: int, batch_idx: int = 0) -> int:
        """Monotonic checkpoint step id. Plain epoch numbering unless
        mid-epoch checkpointing is on (then epoch*1e6+batch keeps saves
        ordered)."""
        if self.cfg.checkpoint_every_batches:
            return epoch * 1_000_000 + batch_idx
        return epoch

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start_trace(self):
        # the host's activity carries the step's myt: spans, the card's its work
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()   # batch 0 fully done
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()

    def _stop_trace(self) -> str:
        self._sync()
        self._profiler.stop()
        os.makedirs(self._profile_dir(), exist_ok=True)
        path = os.path.join(self._profile_dir(), f"trace_{os.getpid()}_{time.time_ns()}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        self._profiled = True
        return path

    # -------------------------------------------------------------- train --
    def train_epoch(self, loader: Iterable, epoch: int, start_batch: int = 0) -> dict:
        sync_processes("pre_epoch")
        lr = learning_rate_for_epoch(self.cfg.learning_rate, epoch,
                                     self.cfg.schedule, self.cfg.warm_up)
        self.state = self.state.with_lr(lr)
        # keep the Loader's plan in lockstep with the training epoch so a
        # resumed run sees the SAME shuffle/augmentation plan the
        # uninterrupted run would (plain iteration counting would restart
        # a resumed run's plans at epoch 1)
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        if start_batch:
            if hasattr(loader, "set_skip"):
                loader.set_skip(start_batch)   # skipped without decoding
            else:
                loader = itertools.islice(iter(loader), start_batch, None)
            self._log(f"  resuming epoch {epoch} at batch {start_batch}")
        meters = MeterDict()
        start = time.time()
        # one-shot trace: let batches 0-1 warm up, then capture the next
        # profile_steps steps (the trace starts after a synchronize on batch
        # 1 and stops after one on the last traced step)
        profile_at = (1 if (self.cfg.profile_steps and not self._profiled
                            and start_batch == 0) else None)

        # Metrics are read one batch late: ``float`` of a tensor on the card
        # waits for it, so reading step i's metrics right after queueing it
        # would leave the card idle while the host builds step i+1. With the
        # delay the host has queued step i+1 before it waits for step i
        # (reads still fire the NaN tripwire, one batch late).
        pending: tuple | None = None

        def drain(p):
            j, p_bs, p_metrics = p
            # one copy to the host for all of a step's metrics
            values = torch.stack([v.detach().to(torch.float64)
                                  for v in p_metrics.values()]).tolist()
            p_metrics = dict(zip(p_metrics, values))
            loss_val = p_metrics["loss"]
            if not np.isfinite(loss_val):
                # NaN tripwire (reference yolo_loss.py:231-232)
                self._log(f"WARNING: non-finite loss {loss_val} at "
                          f"epoch {epoch} batch {j}")
            meters.update(p_metrics, p_bs)
            if self.verbose and j % self.cfg.log_suffix_every == 0:
                a = meters.averages()
                self._log(
                    f"  e{epoch} b{j}: loss {a.get('loss', 0):.4f} "
                    f"iou {(a.get('avg_iou0', 0) + a.get('avg_iou1', 0)) / 2:.3f} "
                    f"obj {(a.get('obj0', 0) + a.get('obj1', 0)) / 2:.3f} "
                    f"recall {(a.get('recall0', 0) + a.get('recall1', 0)) / 2:.3f}")

        for j, batch in enumerate(loader):
            i = start_batch + j    # absolute batch index within the epoch
            # a fresh (pinned) copy: the loader may reuse its buffers at once
            t = batch_to_device(batch, self.device)
            if self.device_geometry:
                args = tuple(t[k] for k in GEOMETRY_BATCH_KEYS)
                if self.segmentation:
                    args += (t["seg_slots"], t["seg_active"])
                args += (t["gt"], t["n_gt"])
                if self.mesh is not None:
                    args = shard_batch(self.mesh, args)
                self.state, metrics = self.train_step(
                    self.state, *args, aug_seed(epoch, i), out_hw=batch["out_size"])
            else:
                seg = (t["seg_maps"],) if self.segmentation else ()
                jit_plan = ()
                if self.device_pixel_aug:
                    # host-planned per-image photometric programs (op order
                    # + factors), applied on device in planned order
                    if "jitter_op" not in batch:
                        raise ValueError(
                            "device_pixel_aug=True but the batch carries "
                            "no jitter plans — build the dataset with "
                            "apply_photometric=False so the Loader emits "
                            "them (cli/train.py wires this; see "
                            "Loader._collate)")
                    jit_plan = (t["jitter_op"], t["jitter_factor"])
                elif "jitter_op" in batch:
                    raise ValueError(
                        "batch carries host-planned jitter programs but "
                        "device_pixel_aug=False — the photometric "
                        "augmentation would be silently dropped; pass "
                        "device_pixel_aug=True (or rebuild the dataset "
                        "with apply_photometric=True)")
                args = (t["images"], t["gt"], t["n_gt"], *seg, *jit_plan)
                if self.mesh is not None:
                    args = shard_batch(self.mesh, args)
                self.state, metrics = self.train_step(self.state, *args)
            if profile_at is not None:
                if j == profile_at:
                    self._start_trace()
                if j == profile_at + self.cfg.profile_steps:
                    self._stop_trace()
                    profile_at = None
                    self._log(f"  wrote {self.cfg.profile_steps}-step "
                              f"device trace to {self._profile_dir()}")
            if pending is not None:
                drain(pending)
            pending = (i, batch["gt"].shape[0], metrics)
            every = self.cfg.checkpoint_every_batches
            if every and (i + 1) % every == 0:
                # mid-epoch snapshot: (epoch, batch_idx) ride the state so
                # a killed run resumes at exactly this batch
                self.state.batch_idx = i + 1
                self.ckpt.save(self._ckpt_step(epoch, i + 1), self.state)
        if pending is not None:
            drain(pending)
        if self._trace_open:
            # profile_steps >= the epoch's remaining batches: the in-loop
            # stop never fired — close the (shorter) trace here rather
            # than leaving it open into the next epoch
            self._stop_trace()
            self._log(f"  wrote device trace (shorter than the requested "
                      f"{self.cfg.profile_steps} steps — epoch ended) to "
                      f"{self._profile_dir()}")
        avgs = meters.averages()
        avgs["lr"] = lr
        avgs["epoch_time"] = time.time() - start
        return avgs

    # --------------------------------------------------------------- eval --
    def evaluate(self, loader: Iterable, batch_size: int | None = None
                 ) -> tuple[float, dict]:
        sync_processes("pre_eval")
        # with EMA on, evaluate (and thereby select/save the best model
        # with) the averaged weights; BN stats are already a running
        # average, so the live ones pair with them (train/state.py). The
        # average is copied into the parameters and the live values back
        # after, in place, so the optimizer keeps its parameter objects.
        live = None
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            if self.state.ema is not None:
                live = {name: p.detach().clone() for name, p in params.items()}
                for name, p in params.items():
                    p.copy_(self.state.ema[name])
        # the train step leaves the model in train mode: BatchNorm must use
        # (and leave unchanged) its running statistics here
        self.model.eval()
        try:
            res = evaluate_detection(
                self.predict, loader, self.classes_name, float(self.state.val_conf),
                batch_size=batch_size, log=self._log if self.verbose else None,
                device=self.device, mesh=self.mesh)
        finally:
            if live is not None:
                with torch.no_grad():
                    for name, p in params.items():
                        p.copy_(live[name])
        self.state.val_conf = res["new_conf"]
        return res["mAP"], res["aps"]

    # ---------------------------------------------------------------- fit --
    def fit(self, train_loader_fn: Callable[[], Iterable],
            eval_loader_fn: Callable[[], Iterable],
            start_epoch: int | None = None) -> float:
        cfg = self.cfg
        if self.logger is None and self._primary:
            path = os.path.join(cfg.checkpoint_dir, "log.txt")
            resume = os.path.isfile(path) and start_epoch != 0
            self.logger = Logger(path, title="training-process", resume=resume)
            self.logger.set_names(["Epoch", "Loss", "Precision", "Time",
                                   "IOU", "LearningRate"])
        first = int(self.state.epoch) if start_epoch is None else start_epoch
        # mid-epoch resume: the restored state says how many batches of
        # epoch `first` were already consumed (0 on epoch boundaries)
        start_batch = int(self.state.batch_idx) if start_epoch is None else 0
        test_acc = self.best_acc  # carried over a resume until the next eval
        for epoch in range(first, cfg.epochs):
            st = time.time()
            stats = self.train_epoch(train_loader_fn(), epoch,
                                     start_batch=start_batch)
            start_batch = 0
            self.tb.scalar("Loss/train", stats.get("loss", 0.0), epoch)
            iou = (stats.get("avg_iou0", 0) + stats.get("avg_iou1", 0)) / 2
            self.tb.scalar("iou/train", iou, epoch)

            self.state.epoch = epoch + 1
            self.state.batch_idx = 0
            evaluate_now = (epoch % cfg.eval_every) == (cfg.eval_every - 1)
            if evaluate_now:
                test_acc, _ = self.evaluate(eval_loader_fn())
                self.report.intermediate(test_acc)
                self.best_acc = max(test_acc, self.best_acc)
                self.state.best_acc = self.best_acc
                self.tb.scalar("Accuracy/test", test_acc, epoch + 1)
                self.ckpt.save(self._ckpt_step(epoch + 1), self.state,
                               mAP=test_acc)
            else:
                self.ckpt.save(self._ckpt_step(epoch + 1), self.state)
            if self.logger:
                self.logger.append([epoch + 1, stats.get("loss", 0.0),
                                    test_acc, time.time() - st, iou,
                                    stats["lr"]])
        self.report.final(self.best_acc)
        self.ckpt.close()
        self.tb.close()
        if self.logger:
            self.logger.close()
        return self.best_acc
