"""The single-process seam of ``mobilenet_yolo_tpu/parallel/mesh.py``.

The training loop imports ``shard_batch`` and ``sync_processes``
(``train/loop.py:22``, ``:227``) and the CLIs ``mesh_from_spec``. Until
the parallelism port (ROADMAP Queue 1 item 8) the port runs one process
on one device: every ``--mesh`` spec that means one device gives ``None``,
any other raises, and the barrier is a no-op.
"""

from __future__ import annotations

import torch

_ITEM_8 = "ROADMAP Queue 1 item 8, parallel/mesh.py and parallel/sharding.py"


def mesh_from_spec(spec: str, batch_size: int | None = None) -> None:
    """``None`` for the specs that mean one device: ``none``, ``off``, ``1``,
    and ``auto`` where at most one card is visible (``auto`` over several
    cards is data parallelism in the JAX package). Any other spec raises
    ``NotImplementedError``. ``batch_size`` is the JAX signature's; one
    device takes any batch."""
    spec = (spec or "auto").strip().lower()
    if spec in ("none", "off", "1"):
        return None
    if spec == "auto" and torch.cuda.device_count() <= 1:
        return None
    raise NotImplementedError(
        f"--mesh {spec} needs more than one device ({torch.cuda.device_count()} cards "
        f"visible); the port runs one device until {_ITEM_8}: pass --mesh none")


def shard_batch(mesh, tree):
    """Placement of a batch over a mesh: no mesh exists before item 8."""
    raise NotImplementedError(f"shard_batch needs a device mesh ({_ITEM_8})")


def sync_processes(name: str, timeout_ms: int = 600_000) -> None:
    """Cross-process barrier at a phase boundary: a no-op in one process."""
