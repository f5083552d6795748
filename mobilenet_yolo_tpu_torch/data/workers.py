"""Worker-process input pipeline: ``WorkerLoader``, the port's counterpart of
``mobilenet_yolo_tpu/data/grain_pipeline.py:GrainLoader``.

``import grain`` imports JAX, so the port runs the same design on
``torch.utils.data.DataLoader``: a map-style dataset whose items are the
entries of the epoch plan (``Loader._sharded_plan``: mosaic groups, the
per-batch multiscale size, this rank's slice), each item one whole batch
built with the per-batch generator ``np.random.default_rng((seed, epoch,
rank, batch_idx))`` (``grain_pipeline.py:40-53``). Worker parallelism is
at batch granularity, and the batches are the ``Loader``'s, in the same
order, whatever ``num_workers`` is.

Workers start with ``spawn`` (a fork would copy the parent's threads'
locks); each unpickles the loader, whose ``RecordReader`` reopens the
shard. The slot ring is off, as in the JAX loader (``grain_pipeline.py:
25-31``): a batch crosses processes, so each gets fresh arrays.
"""

from __future__ import annotations

from typing import Iterator

import torch.utils.data

from mobilenet_yolo_tpu_torch.data.pipeline import Loader


def _as_is(batch: dict) -> dict:
    """The DataLoader's collate: the batch stays numpy, as ``Loader``'s."""
    return batch


class _PlanEntries(torch.utils.data.Dataset):
    """One epoch's remaining plan entries; item i is the i-th batch."""

    def __init__(self, loader: Loader, entries: list, p_idx: int, epoch: int):
        self.loader = loader
        self.entries = entries
        self.p_idx = p_idx
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> dict:
        batch_idx, (groups, size_idx) = self.entries[i]
        return self.loader._build_batch(batch_idx, groups, size_idx, self.p_idx, self.epoch)


class WorkerLoader(Loader):
    """``Loader`` whose batches are built in ``num_workers`` processes
    (``num_workers=0``: in the loading thread itself). ``Loader.__iter__``
    still runs the epoch on its prefetch thread when ``prefetch > 0``."""

    def __init__(self, *args, num_workers: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_workers = num_workers
        if self.device_geometry:
            # batches cross processes and queue up in the DataLoader: a
            # reuse ring would alias them, so every batch gets fresh slots
            self._use_slot_ring = False

    def _epoch_batches(self) -> Iterator[dict]:
        entries, p_idx = self._remaining_plan()
        yield from torch.utils.data.DataLoader(
            _PlanEntries(self, entries, p_idx, self.epoch), batch_size=None,
            shuffle=False, num_workers=self.num_workers, collate_fn=_as_is,
            multiprocessing_context="spawn" if self.num_workers else None)
