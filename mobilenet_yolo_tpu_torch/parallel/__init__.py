"""Parallelism (port of ``mobilenet_yolo_tpu/parallel/``): for now only the
single-process seam the training loop imports (``mesh.py``); data and
tensor parallelism over ``torch.distributed`` are ROADMAP Queue 1 item 8."""

from mobilenet_yolo_tpu_torch.parallel.mesh import (  # noqa: F401
    mesh_from_spec,
    shard_batch,
    sync_processes,
)
