"""Checkpointing with auto-resume (port of ``mobilenet_yolo_tpu/train/checkpoints.py``).

``torch.save`` takes the place of Orbax. Each step is a directory
``<directory>/<step>/`` holding ``state.pt`` and ``metrics.json``; it is
written under a temporary name and moved into place with ``os.replace``,
so a save that is killed leaves no half checkpoint, only a temporary
directory that no reader lists. ``state.pt`` holds:

* ``model``: the model's ``state_dict`` (parameters and BatchNorm
  statistics), on the CPU;
* ``optimizer``: the optimizer's ``state_dict`` (AdamW's moments and step);
* ``ema``: the averaged parameters by name, or ``None`` when the run kept
  no average;
* ``epoch``, ``best_acc``, ``val_conf`` and ``batch_idx``.

Retention is Orbax's under the JAX manager's options (``max_to_keep``,
``best_fn`` = the mAP, ``keep_checkpoints_without_metrics``), as Orbax
0.11 applies them: of the steps saved with an mAP the ``max_to_keep``
best stay (between equal mAPs, the newer), every step saved without one
stays, and so does the newest step. Orbax deletes the newest step when its
mAP is not among the best, and auto-resume then goes back to an older
epoch; the port keeps it.

Under a process group every rank calls ``save``: the tensors a
tensor-parallel layer splits are gathered first (a collective), so a
checkpoint holds full tensors under any mesh and loads in one process
with ``strict=True``; rank 0 writes and prunes, and the others wait for it
at a barrier. Every rank can restore; a split layer takes its own slice.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from mobilenet_yolo_tpu_torch.parallel.mesh import is_primary, sync_processes
from mobilenet_yolo_tpu_torch.parallel.sharding import gather_full, map_split, own_slice
from mobilenet_yolo_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
_TMP_PREFIX = ".tmp-"


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def state_payload(state: TrainState) -> dict:
    """What ``save`` writes for ``state``: full tensors, gathered from a
    tensor-parallel model's slices (a collective then)."""
    model_sd, optimizer_sd, ema = map_split(state, state.model.state_dict(),
                                            state.optimizer.state_dict(), state.ema, gather_full)
    return {"model": _cpu(model_sd),
            "optimizer": optimizer_sd,
            "ema": _cpu(ema) if ema is not None else None,
            "epoch": int(state.epoch), "best_acc": float(state.best_acc),
            "val_conf": float(state.val_conf), "batch_idx": int(state.batch_idx)}


def served_state_dict(raw: dict) -> dict:
    """The model weights to serve from a restored payload: the averaged
    parameters where the run kept them (the weights it evaluated and chose
    its best by, ``cli/infer.py:60-63`` in JAX), with the live BatchNorm
    statistics; otherwise the live weights."""
    weights = dict(raw["model"])
    if raw.get("ema") is not None:
        weights.update(raw["ema"])
    return weights


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        # temporary directories of saves that never finished
        for name in os.listdir(self.directory) if is_primary() else ():
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(os.path.join(self._path(n), STATE_FILE)))

    def _metrics(self, step: int) -> Optional[dict]:
        with open(os.path.join(self._path(step), METRICS_FILE)) as f:
            return json.load(f)

    def _ranked(self) -> list[int]:
        """The steps saved with an mAP, worst first (between equal mAPs the
        older first), as Orbax orders them for ``best_mode="max"``."""
        scored = [(m["mAP"], step) for step in self.all_steps()
                  if (m := self._metrics(step)) is not None]
        return [step for _, step in sorted(scored)]

    def save(self, step: int, state: TrainState, mAP: float | None = None,
             wait: bool = False):
        """Write ``state`` as ``step``. The write is synchronous, so ``wait``
        (Orbax's wait for its background save) has nothing to wait for.
        Under a process group every rank calls it; rank 0 writes."""
        payload = state_payload(state)
        if is_primary():
            if os.path.exists(self._path(step)):
                raise ValueError(f"checkpoint step {step} already exists in {self.directory}")
            tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                json.dump({"mAP": float(mAP)} if mAP is not None else None, f)
            os.replace(tmp, self._path(step))
            self._retain()
        sync_processes("checkpoint_saved")

    def _retain(self) -> None:
        ranked = self._ranked()
        newest = self.latest_step()
        for step in ranked[:max(0, len(ranked) - self.max_to_keep)]:
            if step != newest:
                shutil.rmtree(self._path(step))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    def restore_raw(self, step: int) -> dict:
        """Step ``step``'s payload as saved, its tensors on the CPU."""
        return torch.load(os.path.join(self._path(step), STATE_FILE), map_location="cpu",
                          weights_only=True)

    def restore(self, step: int, template: TrainState) -> TrainState:
        """Load step ``step`` into ``template`` (its model, optimizer and
        bookkeeping, in place) and return it. The checkpoint must carry
        an average exactly when the template does
        (``restore_latest_flexible`` bridges the two)."""
        raw = self.restore_raw(step)
        if (raw["ema"] is None) != (template.ema is None):
            raise ValueError(
                f"checkpoint {step} {'has no' if raw['ema'] is None else 'has an'} EMA average "
                f"and the template {'keeps' if template.ema is not None else 'keeps none'}: "
                "use restore_latest_flexible")
        return _load_into(template, raw, raw["ema"])

    def restore_latest(self, template: TrainState) -> Optional[TrainState]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, template)

    def restore_latest_flexible(self, template: TrainState) -> Optional[TrainState]:
        """``restore_latest`` across a change of ``--ema-decay`` between the
        saving and the resuming run (``checkpoints.py:63-136`` in JAX): a
        checkpoint without an average, resumed into a run that keeps one,
        seeds the average from the restored parameters; a checkpoint with
        an average, resumed into a run without one, drops it."""
        step = self.latest_step()
        if step is None:
            return None
        raw = self.restore_raw(step)
        ema = None
        if template.ema is not None:
            ema = raw["ema"]
            if ema is None:
                ema = {name: raw["model"][name] for name in template.ema}
        return _load_into(template, raw, ema)

    def restore_latest_raw(self) -> Optional[dict]:
        """The latest step's payload (``state.pt``'s dict, tensors on the
        CPU) without a template: the serving and eval CLIs read the
        weights from it (``served_state_dict``) whatever the run's
        options, and a checkpoint written on the card restores on the CPU."""
        step = self.latest_step()
        if step is None:
            return None
        return self.restore_raw(step)

    def close(self):
        """Nothing is in flight: every save finished before it returned."""


def _load_into(state: TrainState, raw: dict, ema: Optional[dict]) -> TrainState:
    model_sd, optimizer_sd, ema = map_split(state, raw["model"], raw["optimizer"], ema, own_slice)
    state.model.load_state_dict(model_sd, strict=True)
    state.optimizer.load_state_dict(optimizer_sd)
    if ema is None:
        state.ema = None
    else:
        params = dict(state.model.named_parameters())
        if set(ema) != set(params):
            raise KeyError("the checkpoint's EMA average does not name the model's parameters")
        state.ema = {name: ema[name].to(device=p.device, dtype=p.dtype).clone()
                     for name, p in params.items()}
    state.epoch = int(raw["epoch"])
    state.best_acc = float(raw["best_acc"])
    state.val_conf = float(raw["val_conf"])
    state.batch_idx = int(raw["batch_idx"])
    return state
