"""Parallelism over ``torch.distributed`` (port of ``mobilenet_yolo_tpu/parallel/``):
process groups, the ``(data, model)`` mesh and batch placement
(``mesh.py``), and tensor parallelism (``sharding.py``). JAX's
``warmup_collectives`` is not ported, and its ``batch_sharding`` /
``replicated`` placements have no use here.

``sharding`` is imported on first use: it subclasses the models'
BatchNorm, and the models import ``mesh``.
"""

from mobilenet_yolo_tpu_torch.parallel.mesh import (  # noqa: F401
    create_mesh,
    global_batch,
    initialize_distributed,
    mesh_from_spec,
    multihost_env_detected,
    shard_batch,
    sync_processes,
)

_SHARDING = ("replicate", "shard_over_model_axis")


def __getattr__(name: str):
    if name in _SHARDING:
        from mobilenet_yolo_tpu_torch.parallel import sharding
        return getattr(sharding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
