"""Process groups, the device mesh and batch placement over ``torch.distributed``.

Port of ``mobilenet_yolo_tpu/parallel/mesh.py``. In JAX one process drives
many devices and a mesh is a grid of them; here one process drives one
device, so a mesh of N devices is N ranks. Ranks are laid out data-major,
as ``create_mesh``'s ``reshape(n_data, n_model)`` lays out devices: rank
``d * n_model + m`` sits at data index ``d`` and model index ``m``. The
mesh holds two process groups for each rank: its ``data`` group (the
ranks of its model index, which split the batch) and its ``model`` group
(the ranks of its data index, which split the large output channels,
``parallel/sharding.py``).

GSPMD turns a mean over the batch axis into a collective by itself. The
port asks for each one: the step builders hand the mesh's data group to
every BatchNorm (its ``process_group``, ``models/layers.py``) and to the
loss (``ops/losses.py``, ``ops/assign.py``), whose statistics and
normalisers are then sums over the group's rows (``global_sum``,
``differentiable_sum``); with no group they are this process's own.

The gloo clique warmup (``warmup_collectives``) is not ported: gloo's
process groups here are made once, at ``create_mesh``, not per program.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

def multihost_env_detected() -> bool:
    """True when the environment is one process of a launched job: what
    ``torchrun`` exports, ``WORLD_SIZE`` above 1 with ``MASTER_ADDR`` set.
    A plain single process never trips it."""
    env = os.environ
    try:
        world = int(env.get("WORLD_SIZE", "1"))
    except ValueError:
        return False
    return world > 1 and bool(env.get("MASTER_ADDR"))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """Rank 0 (or the only process): the one that logs and writes."""
    return rank() == 0


def rank_device(device: str | torch.device) -> torch.device:
    """This rank's device: ``cuda`` without an index becomes
    ``cuda:{LOCAL_RANK % device_count()}`` (the rank where ``LOCAL_RANK`` is
    not set), so several ranks may share one card; anything else as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", rank()))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def default_backend(device: str | torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for any other."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def join_process_group(init_method: str, world_size: int | None = None,
                       rank: int | None = None, *, backend: str | None = None,
                       device: str | torch.device | None = None,
                       timeout_s: float = 1800.0) -> None:
    """Initialise the default process group at ``init_method``
    (``tcp://host:port``, ``env://``, ``file://``) with ``world_size`` and
    ``rank`` (from the environment under ``env://``). ``backend`` is
    ``nccl`` when the process's device (``device``, else the card when
    there is one) is CUDA, ``gloo`` otherwise; pass ``backend="gloo"`` for
    several ranks on one card, which NCCL refuses. On a CUDA device the
    rank's card (``rank_device``) becomes the current device."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    coords = {k: int(v) for k, v in (("world_size", world_size), ("rank", rank))
              if v is not None}
    dist.init_process_group(backend or default_backend(device), init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **coords)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device))


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           backend: str | None = None,
                           device: str | torch.device | None = None,
                           timeout_s: float = 1800.0) -> bool:
    """Join the process group; returns True when it was initialised.

    Explicit coordinates (``coordinator`` ``host:port``, ``num_processes``
    above 1, ``process_id``) take precedence; with none given, a job that
    ``torchrun`` launched (``multihost_env_detected``) joins through the
    environment. A plain single process is a no-op, so CLIs may call this
    unconditionally. ``backend`` and ``device``: ``join_process_group``.
    """
    if num_processes is not None and num_processes > 1:
        if coordinator is None or process_id is None:
            raise ValueError("--num-processes above 1 needs --coordinator and --process-id")
        join_process_group(f"tcp://{coordinator}", num_processes, process_id,
                           backend=backend, device=device, timeout_s=timeout_s)
    elif coordinator is None and num_processes is None and multihost_env_detected():
        join_process_group("env://", backend=backend, device=device, timeout_s=timeout_s)
    else:
        return False
    return True


class Mesh:
    """A ``(data, model)`` grid of ranks and this rank's place on it.

    ``shape`` is ``{"data": n_data, "model": n_model}``, the dict the JAX
    mesh's ``.shape`` gives. ``data_group`` / ``model_group`` are this
    rank's process groups, ``None`` when no process group is initialised
    (one process, a 1x1 mesh)."""

    def __init__(self, n_data: int, n_model: int, data_group=None, model_group=None):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.data_group = data_group
        self.model_group = model_group
        r = rank()
        self.data_index, self.model_index = divmod(r, n_model)

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def n_model(self) -> int:
        return self.shape["model"]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, data_index={self.data_index}, "
                f"model_index={self.model_index})")


def create_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The ``(n_data, n_model)`` mesh over every rank of the process group.

    JAX may build a mesh over some of its devices; here every rank must be
    on the mesh, since each rank runs the same program. Every rank calls
    this with the same shape (it makes the groups, a collective).
    """
    world = world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model} ranks; "
                         f"the process group has {world}")
    if not is_initialized():
        return Mesh(n_data, n_model)
    mine = rank()
    data_group = model_group = None
    # every rank creates every group, in one order
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        group = dist.new_group(ranks)
        if mine in ranks:
            data_group = group
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        group = dist.new_group(ranks)
        if mine in ranks:
            model_group = group
    return Mesh(n_data, n_model, data_group, model_group)


def mesh_shape(spec: str, n_dev: int, batch_size: int | None = None) -> tuple[int, int] | None:
    """``(n_data, n_model)`` of a ``--mesh`` spec over ``n_dev`` ranks, or
    ``None`` for one device (``mesh.py:99-132``):

    * ``auto`` — data parallelism over every rank when there is more than
      one, else ``None``;
    * ``none``/``off``/``1`` — ``None``;
    * ``N`` — N-way data parallelism; ``NxM`` — N-way data x M-way model.

    Raises ``ValueError`` when the mesh needs more ranks than there are, or
    when ``batch_size`` (the global batch) does not split over the data axis.
    """
    spec = (spec or "auto").strip().lower()
    if spec in ("none", "off", "1"):
        return None
    if spec == "auto":
        if n_dev <= 1:
            return None
        n_data, n_model = n_dev, 1
    elif "x" in spec:
        a, b = spec.split("x", 1)
        n_data, n_model = int(a), int(b)
    else:
        n_data, n_model = int(spec), 1
    if n_data * n_model > n_dev:
        raise ValueError(f"--mesh {spec} needs {n_data * n_model} devices, {n_dev} visible")
    if batch_size is not None and batch_size % n_data:
        raise ValueError(
            f"global batch {batch_size} is not divisible by the mesh's "
            f"data axis {n_data}; adjust --batch-size or --mesh")
    return n_data, n_model


def mesh_from_spec(spec: str, batch_size: int | None = None) -> Mesh | None:
    """CLI-facing mesh construction from a ``--mesh`` spec (``mesh_shape``),
    counting the process group's ranks where JAX counts ``jax.devices()``."""
    shape = mesh_shape(spec, world_size(), batch_size)
    return None if shape is None else create_mesh(*shape)


def sync_processes(name: str, timeout_ms: int = 600_000) -> None:
    """A barrier on the default group at a phase boundary (``name`` is the
    JAX signature's, for the logs). gloo's barrier honours ``timeout_ms``;
    NCCL's has the group's own. A no-op in one process."""
    if world_size() <= 1:
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=datetime.timedelta(milliseconds=timeout_ms))
    else:
        dist.barrier()


def _leaves_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _leaves_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree):
    """A batch that this rank already holds its slice of (the loaders cut
    each batch per rank): each rank's tensors stay where they are, on its
    device. Returns ``tree``, after checking that its batch leaves agree
    on their rows."""
    rows = set()
    _leaves_map(lambda x: rows.add(x.shape[0]) if getattr(x, "ndim", 0) else None, tree)
    if len(rows) > 1:
        raise ValueError(f"the batch's leaves disagree on their rows: {sorted(rows)}")
    return tree


def global_batch(mesh: Mesh, tree):
    """This rank's rows, along the data axis, of a HOST-COMPLETE batch
    (every rank holds the same full batch, e.g. the eval loader's); a
    rank-0 leaf is replicated as it is (``mesh.py:224-248``). The dual of
    ``shard_batch``."""
    def place(x):
        if not getattr(x, "ndim", 0):
            return x
        n = x.shape[0]
        if n % mesh.n_data:
            raise ValueError(f"a batch of {n} rows does not split over the data axis "
                             f"{mesh.n_data}")
        local = n // mesh.n_data
        return x[mesh.data_index * local:(mesh.data_index + 1) * local]
    return _leaves_map(place, tree)


# ------------------------------------------------------------ collectives --


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``; ``t`` itself with no group."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, in rank order, concatenated along
    ``dim``; ``t`` with no group. Booleans travel as bytes."""
    if group is None:
        return t
    as_bool = t.dtype == torch.bool
    x = (t.to(torch.uint8) if as_bool else t).contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    return out.bool() if as_bool else out


class _AllReduce(torch.autograd.Function):
    """Sum over a group whose backward sums the gradients over it again:
    every rank's loss depends on every rank's contribution. Given
    ``total`` (the sum a first pass took) the forward returns it and calls
    no collective: remat's recompute runs so, and calls only the backward's."""

    @staticmethod
    def forward(ctx, x, group, total):
        ctx.group = group
        if total is not None:
            return total.clone()
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


def differentiable_sum(x: torch.Tensor, group, total: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` summed over ``group``, with gradients summed back over it.
    With ``total`` (the sum a first pass already took) no collective runs
    forward."""
    return _AllReduce.apply(x, group, total)


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (detached) summed over ``group``; ``x`` itself with no group."""
    if group is None:
        return x
    return all_reduce_(x.detach().clone(), group)
