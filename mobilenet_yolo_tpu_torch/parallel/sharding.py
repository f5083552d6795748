"""Tensor parallelism: the output channels of large layers split over the
``model`` axis (port of ``mobilenet_yolo_tpu/parallel/sharding.py``).

The rule is JAX's ``_leaf_sharding``: a leaf whose output-channel size is
at least ``min_channels`` and divisible by the model axis is split along
that axis; everything else is replicated. JAX reads the size as
``shape[-1]`` of a flax leaf (an HWIO kernel's output channels, a BN or
bias vector's channels); the port reads it on the torch axis that holds
that flax axis (``convert.flax_last_axis``: axis 0 of an OIHW weight), so
both packages split the same leaves by flax path. The leaves of one layer
share their channel count, so a layer is split whole: its weight and bias,
or its BN affine parameters and running statistics, AdamW's moments and
the EMA average of each (matched by name).

GSPMD partitions the convolutions itself. Here a split layer is a
column-parallel module (``ShardedConv2d``, ``ShardedBatchNorm2d``): it
takes the full input, computes its slice of the output channels and
gathers them over the model group. Every rank of a model group computes
the same loss downstream, so the gather's backward hands each rank its
own slice of the gradient (no sum over the group), and the input's
gradient, each rank's part of it, is summed over the group. The
replicated parameters' gradients, which every rank of a model group
computes for itself, are then taken from the group's first rank
(``agree_replicated_gradients``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from mobilenet_yolo_tpu_torch.convert import flax_last_axis
from mobilenet_yolo_tpu_torch.models.layers import BatchNorm2d
from mobilenet_yolo_tpu_torch.parallel.mesh import all_gather_cat, is_initialized


def leaf_is_split(t: torch.Tensor, n_model: int, min_channels: int = 256) -> bool:
    """JAX's ``_leaf_sharding`` test on one state-dict tensor of the port:
    its output-channel size at least ``min_channels`` and divisible by the
    model axis (0-d tensors replicate)."""
    if t.ndim == 0 or n_model == 1:
        return False
    size = t.shape[flax_last_axis(t.ndim)]
    return size >= min_channels and size % n_model == 0


class _CopyToModel(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the model group:
    each rank's backward reaches the input through its channels only."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """Every rank's channel slice, concatenated in rank order along dim 1;
    the backward hands back this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y, group, index):
        ctx.index, ctx.width = index, y.shape[1]
        return all_gather_cat(y, group, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.index * ctx.width, ctx.width).contiguous(), None, None


class _SumSlices(torch.autograd.Function):
    """Every rank's value summed over the model group; the backward hands
    each rank the gradient of its own value (no sum over the group)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_of_slices(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (a sum over this rank's slices) summed over the model group.
    Every rank of the group carries the same loss, so, as the gather's
    backward hands each rank its slice of the gradient, each rank's ``x``
    gets the loss's gradient once; ``mesh.differentiable_sum``, whose
    backward sums the gradient over the group, would count it ``n_model``
    times."""
    return _SumSlices.apply(x, group)


class _Split:
    """What a column-parallel module keeps: its model group, its slice."""

    tp_group = None
    tp_index = 0
    tp_width = 0

    def _local_input(self, x: torch.Tensor, narrow: bool) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.tp_group)
        return x.narrow(1, self.tp_index * self.tp_width, self.tp_width) if narrow else x

    def _gathered(self, y: torch.Tensor) -> torch.Tensor:
        return _GatherChannels.apply(y, self.tp_group, self.tp_index)


class ShardedConv2d(_Split, nn.Conv2d):
    """A conv holding its slice of the output channels; a depthwise conv
    also reads only its slice of the input channels."""

    tp_depthwise = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._local_input(x, self.tp_depthwise)
        return self._gathered(self._conv_forward(x, self.weight, self.bias))


class ShardedBatchNorm2d(_Split, BatchNorm2d):
    """A BatchNorm holding its channels' slice; its statistics are still
    reduced over the data group (``BatchNorm2d``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._gathered(super().forward(self._local_input(x, True)))


def _split_modules(model: nn.Module, n_model: int, min_channels: int) -> list[tuple[str, nn.Module]]:
    """The conv and BN layers the rule splits; each layer's tensors must
    agree (they share the channel count)."""
    out = []
    for name, mod in model.named_modules():
        if not isinstance(mod, (nn.Conv2d, BatchNorm2d)):
            continue
        own = [t for t in (*mod.parameters(recurse=False), *mod.buffers(recurse=False))
               if t.ndim > 0]
        votes = {leaf_is_split(t, n_model, min_channels) for t in own}
        if len(votes) > 1:
            raise ValueError(f"the split rule disagrees within layer {name!r}")
        if votes == {True}:
            out.append((name, mod))
    return out


def _unpack(state_or_model):
    if isinstance(state_or_model, nn.Module):
        return state_or_model, None
    return state_or_model.model, state_or_model


def _broadcast(tensors, group, src: int) -> None:
    if not is_initialized():
        return
    for t in tensors:
        dist.broadcast(t.data, src=src, group=group)


def _state_tensors(model: nn.Module, state) -> list[torch.Tensor]:
    tensors = [*model.parameters(), *model.buffers()]
    if state is not None and state.ema is not None:
        tensors += list(state.ema.values())
    return tensors


def replicate(state_or_model, mesh):
    """Make every rank of each data group hold its first rank's model (and
    EMA average): one broadcast per tensor over the data group. The
    counterpart of JAX's ``replicate``, which places the state replicated;
    the AdamW moments are still empty or restored alike on every rank."""
    model, state = _unpack(state_or_model)
    if mesh is not None and mesh.data_group is not None:
        # the data group's first rank: data index 0 at this model index
        _broadcast(_state_tensors(model, state), mesh.data_group, src=mesh.model_index)
    return state_or_model


def agree_replicated_gradients(model: nn.Module, mesh) -> None:
    """Give every rank of each model group its first rank's gradients of the
    replicated (unsplit) parameters, in one broadcast. GSPMD computes them
    once; here each rank computes them, and the card's backward (atomic
    sums) may round them otherwise on each, which would let the copies of
    a replicated parameter drift apart step by step. A no-op without a
    model axis."""
    if mesh is None or mesh.n_model <= 1 or mesh.model_group is None:
        return
    split = split_tensors(model)
    grads = [p.grad for name, p in model.named_parameters()
             if name not in split and p.grad is not None]
    if not grads:
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    # the model group's first rank: model index 0 at this data index
    dist.broadcast(flat, src=mesh.data_index * mesh.n_model, group=mesh.model_group)
    for g, first in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(first)


def shard_over_model_axis(state_or_model, mesh, min_channels: int = 256):
    """Split every layer the rule selects over the mesh's model group, in
    place: the parameters, buffers, AdamW moments and EMA average keep only
    this rank's channels, and the layer becomes column-parallel. The model
    is first made equal on every rank (a broadcast from rank 0). Returns
    its argument. A model axis of 1 leaves it as it is."""
    model, state = _unpack(state_or_model)
    n_model = mesh.n_model
    if n_model == 1:
        return state_or_model
    _broadcast(_state_tensors(model, state), None, src=0)
    optimizer_state = {} if state is None else state.optimizer.state
    names = {id(p): n for n, p in model.named_parameters()}
    for _, mod in _split_modules(model, n_model, min_channels):
        for key, t in [*mod.named_parameters(recurse=False), *mod.named_buffers(recurse=False)]:
            if t.ndim == 0:
                continue
            width = t.shape[0] // n_model
            lo = mesh.model_index * width
            if isinstance(t, nn.Parameter):
                for moment in optimizer_state.get(t, {}).values():
                    if torch.is_tensor(moment) and moment.shape == t.shape:
                        moment.data = moment.data.narrow(0, lo, width).clone()
                if state is not None and state.ema is not None:
                    ema = state.ema[names[id(t)]]
                    state.ema[names[id(t)]] = ema.narrow(0, lo, width).clone()
                t.data = t.data.narrow(0, lo, width).clone()
            else:
                mod._buffers[key] = t.narrow(0, lo, width).clone()
        width = mod.weight.shape[0]
        if isinstance(mod, nn.Conv2d):
            depthwise = mod.groups > 1 and mod.groups == mod.in_channels == mod.out_channels
            mod.__class__ = ShardedConv2d
            mod.tp_depthwise = depthwise
            mod.out_channels = width
            if depthwise:
                mod.in_channels = mod.groups = width
        else:
            mod.__class__ = ShardedBatchNorm2d
            mod.num_features = width
        mod.tp_group, mod.tp_index, mod.tp_width = mesh.model_group, mesh.model_index, width
    return state_or_model


# ------------------------------------------------- full tensors on disk --


def split_tensors(model: nn.Module) -> dict[str, _Split]:
    """State-dict key -> the column-parallel layer holding a slice of it."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, _Split):
            for key, t in [*mod.named_parameters(recurse=False), *mod.named_buffers(recurse=False)]:
                if t.ndim > 0:
                    out[f"{name}.{key}" if name else key] = mod
    return out


def gather_full(t: torch.Tensor, layer: _Split) -> torch.Tensor:
    """The full tensor from every model rank's slice (a collective)."""
    return all_gather_cat(t.detach(), layer.tp_group, dim=0)


def own_slice(t: torch.Tensor, layer: _Split) -> torch.Tensor:
    """This rank's slice of a full tensor."""
    return t.narrow(0, layer.tp_index * layer.tp_width, layer.tp_width).clone()


def _optimizer_keys(state) -> dict[int, str]:
    """The optimizer's parameter index -> the parameter's state-dict key."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    return {i: names[id(p)] for i, p in enumerate(params)}


def map_split(state, model_sd: dict, optimizer_sd: dict, ema: dict | None, fn):
    """``fn(tensor, layer)`` applied to every split tensor of a model state
    dict, an optimizer state dict (the moments of split parameters) and an
    EMA dict; the rest as it is. Returns the three, new dicts."""
    split = split_tensors(state.model)
    if not split:
        return model_sd, optimizer_sd, ema
    model_sd = {k: fn(v, split[k]) if k in split else v for k, v in model_sd.items()}
    keys = _optimizer_keys(state)
    moments = {}
    for i, entry in optimizer_sd["state"].items():
        layer = split.get(keys[int(i)])
        moments[i] = {k: fn(v, layer) if layer is not None and torch.is_tensor(v) and v.ndim
                      else v for k, v in entry.items()}
    optimizer_sd = {**optimizer_sd, "state": moments}
    if ema is not None:
        ema = {k: fn(v, split[k]) if k in split else v for k, v in ema.items()}
    return model_sd, optimizer_sd, ema
