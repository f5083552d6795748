"""Structured channel pruning (Network Slimming) on the port's models.

Port of ``mobilenet_yolo_tpu/prune.py`` (its module docstring gives the
method: Liu et al. 2017, BatchNorm gammas as channel gates, a global
|gamma| threshold). The JAX package works on flax variable trees; this
module works on the port's modules and ``state_dict``s, whose keys are the
flax paths with dots (``convert.py``), so every site, slot and order is the
JAX package's. The plan is numpy with the same stable argsort, so it is
the JAX plan index for index.

What is prunable, detected from the keys (never by the model's name):

* the expansion (hidden) channels of every backbone block with an expand
  conv (MBv2 ``block{i}``, MBv3 ``bneck{i}`` / ``bneck2_{i}``): the expand
  conv's outputs and BN, the depthwise conv and its BN, the project conv's
  inputs;
* the backbone ``head_conv``'s outputs, with its BN and the detector's
  ``conv_for_S32`` inputs, only where ``conv_for_S32`` is a plain 1x1
  ``ConvBNAct`` (MBv2-YOLO, MBv3-YOLO MACC-lite), not MBv3-YOLO's
  width-coupled ``DepthwiseConvolution``.

API: ``prunable_gammas``, ``plan_prune``, ``apply_prune`` (slices a state
dict and returns the model-yaml ``prune:`` block), ``slim_penalty`` (the
loss-mode L1 term, a differentiable torch sum), ``slim_prox_update`` (the
prox-mode soft threshold in Adam's metric, read from ``torch.optim.AdamW``'s
state) and ``param_count``. ``tools/prune.py`` is the CLI.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
from torch import nn

_HEAD_SITE = "head_conv"
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _block_sites(keys) -> list[str]:
    """Backbone blocks with an expand conv, in definition order: MBv2
    ``block{i}`` (block 0 has none), MBv3 ``bneck{i}`` then ``bneck2_{i}``
    (``prune.py:_block_sites``)."""

    def order(name: str) -> tuple[int, int]:
        for prefix, stage in (("bneck2_", 1), ("bneck", 0), ("block", 0)):
            if name.startswith(prefix):
                return (stage, int(name[len(prefix):]))
        raise KeyError(name)

    names = {k.split(".")[1] for k in keys
             if k.startswith("backbone.") and k.endswith(".expand.bn.weight")}
    return sorted((n for n in names if n.startswith(("block", "bneck"))), key=order)


def _head_prunable(keys) -> bool:
    """``head_conv`` is prunable only where its consumer ``conv_for_S32`` is
    a plain 1x1 ``ConvBNAct`` (``prune.py:_head_prunable``)."""
    keys = set(keys)
    return (f"backbone.{_HEAD_SITE}.bn.weight" in keys
            and "conv_for_S32.conv.weight" in keys)


def _gamma_key(site: str) -> str:
    if site == _HEAD_SITE:
        return f"backbone.{_HEAD_SITE}.bn.weight"
    return f"backbone.{site}.expand.bn.weight"


def _sites(keys, include_head: bool = True) -> list[str]:
    keys = list(keys)
    sites = _block_sites(keys)
    if include_head and _head_prunable(keys):
        sites.append(_HEAD_SITE)
    return sites


def prunable_gammas(state: Mapping[str, torch.Tensor],
                    include_head: bool = True) -> dict[str, np.ndarray]:
    """|gamma| per prunable site, as numpy, from a ``state_dict``."""
    return {site: np.abs(state[_gamma_key(site)].detach().cpu().numpy())
            for site in _sites(state, include_head)}


def plan_prune(state: Mapping[str, torch.Tensor], ratio: float, min_keep: int = 8,
               round_to: int = 8, include_head: bool = True) -> dict[str, np.ndarray]:
    """Keep plan: site -> sorted kept-channel indices (``prune.py:plan_prune``).

    The threshold is the ``ratio``-quantile of all prunable |gamma| pooled;
    per site the kept count is floored at ``min_keep`` and rounded up to
    ``round_to`` by re-admitting the largest-|gamma| pruned channels.
    """
    if not 0.0 <= ratio < 1.0:
        raise ValueError(f"prune ratio must be in [0, 1), got {ratio}")
    gammas = prunable_gammas(state, include_head=include_head)
    pooled = np.sort(np.concatenate(list(gammas.values())))
    cut = int(ratio * pooled.size)
    threshold = -np.inf if cut == 0 else pooled[cut - 1]

    keep: dict[str, np.ndarray] = {}
    for site, g in gammas.items():
        n_keep = int(np.sum(g > threshold))
        n_keep = max(n_keep, min(min_keep, g.size))
        n_keep = min(-(-n_keep // round_to) * round_to, g.size)
        # stable top-k by |gamma|: ties broken by channel index
        order = np.argsort(-g, kind="stable")
        keep[site] = np.sort(order[:n_keep])
    return keep


def _hidden_slot(site: str, block_names: list[str]) -> int:
    """Index of ``site`` in the model's ``backbone_hidden`` tuple."""
    if site.startswith("block"):  # MBv2: slot == block index
        return int(site[len("block"):])
    if site.startswith("bneck2_"):  # MBv3 stage 2 after stage 1
        return (len([n for n in block_names if not n.startswith("bneck2_")])
                + int(site[len("bneck2_"):]))
    return int(site[len("bneck"):])


def apply_prune(state: Mapping[str, torch.Tensor], keep: Mapping[str, np.ndarray]
                ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """Slice a ``state_dict`` along the keep plan (``prune.py:apply_prune``).

    Returns ``(state, prune_cfg)``: a new state dict (the caller's is left
    as it was) that the model rebuilt from ``prune_cfg`` loads with
    ``strict=True``, and the model-yaml ``prune:`` block (``backbone_hidden``
    per block, None where a block is not cut; ``backbone_head`` where the
    head is).
    """
    state = dict(state)
    block_names = sorted({k.split(".")[1] for k in state
                          if k.startswith(("backbone.block", "backbone.bneck"))})
    hidden: list[int | None] = [None] * len(block_names)

    def take(key: str, idx: torch.Tensor, dim: int = 0) -> None:
        state[key] = state[key].index_select(dim, idx.to(state[key].device)).contiguous()

    for site, idx in keep.items():
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.long)
        if site == _HEAD_SITE:
            if not _head_prunable(state):
                raise ValueError("head_conv is not prunable for this graph (its "
                                 "consumer is not a plain 1x1 conv)")
            prefix = f"backbone.{_HEAD_SITE}"
            take(f"{prefix}.conv.weight", idx)
            for k in _BN_KEYS:
                take(f"{prefix}.bn.{k}", idx)
            # the one consumer: the detector's conv_for_S32 input channels
            take("conv_for_S32.conv.weight", idx, 1)
            continue
        prefix = f"backbone.{site}"
        for part in ("expand", "depthwise"):
            # expand (Ch, Cin, 1, 1) and depthwise (Ch, 1, k, k): output channels
            take(f"{prefix}.{part}.conv.weight", idx)
            for k in _BN_KEYS:
                take(f"{prefix}.{part}.bn.{k}", idx)
        take(f"{prefix}.project.conv.weight", idx, 1)
        hidden[_hidden_slot(site, block_names)] = int(idx.numel())

    prune_cfg: dict[str, Any] = {"backbone_hidden": hidden}
    if _HEAD_SITE in keep:
        prune_cfg["backbone_head"] = int(np.asarray(keep[_HEAD_SITE]).size)
    return state, prune_cfg


def _gamma_params(model: nn.Module) -> list[torch.Tensor]:
    params = dict(model.named_parameters())
    return [params[_gamma_key(site)] for site in _sites(model.state_dict())]


def slim_penalty(model: nn.Module) -> torch.Tensor:
    """Sum of |gamma| over the prunable BNs (``prune.py:slim_penalty``),
    differentiable. The ``slim_mode: loss`` term: the step adds ``slim_l1 *
    slim_penalty(model)`` to the loss. The JAX docstring records why it
    fails under AdamW (every gamma shrinks at the same rate); ``prox`` is
    the default.

    Under tensor parallelism (``parallel/sharding.py``) it is the whole
    model's sum on every rank of a model group, as GSPMD sums the sharded
    gammas: a split gamma holds this rank's channels, whose sum is added
    over the model group (``sharding.sum_of_slices``: each rank's slice gets
    its own gradient once), and a replicated gamma, which every rank holds
    whole, is counted once.
    """
    from mobilenet_yolo_tpu_torch.parallel.sharding import split_tensors, sum_of_slices

    split = split_tensors(model)
    params = dict(model.named_parameters())
    gammas = [_gamma_key(site) for site in _sites(model.state_dict())]
    g0 = params[gammas[0]]
    total = torch.zeros((), dtype=g0.dtype, device=g0.device)
    slices, group = torch.zeros_like(total), None
    for key in gammas:
        if key in split:
            slices = slices + params[key].abs().sum()
            group = split[key].tp_group
        else:
            total = total + params[key].abs().sum()
    if group is not None:
        total = total + sum_of_slices(slices, group)
    return total


@torch.no_grad()
def slim_prox_update(model: nn.Module, optimizer: torch.optim.Optimizer, lam: float,
                     eps: float = 1e-8) -> None:
    """The preconditioned proximal L1 step on the prunable gammas, in place
    (``prune.py:slim_prox_update``)::

        gamma <- sign(gamma) * max(|gamma| - lr * lam / (sqrt(v_hat) + eps), 0)

    ``v_hat`` is the gamma's bias-corrected Adam second moment: AdamW's
    ``exp_avg_sq`` over ``1 - beta2 ** step``, with the group's ``lr`` and
    ``betas[1]`` and the state's ``step``, read after ``optimizer.step()``.
    The bias correction is computed in float32, as optax's count and the
    JAX step compute it. A gamma the optimizer holds no state for (no step
    yet) raises.
    """
    groups = {id(p): group for group in optimizer.param_groups for p in group["params"]}
    for gamma in _gamma_params(model):
        state = optimizer.state.get(gamma)
        if not state or "exp_avg_sq" not in state:
            raise RuntimeError("slim_prox_update runs after optimizer.step(): a prunable "
                               "gamma has no Adam state yet")
        group = groups[id(gamma)]
        step = np.float32(float(state["step"]))
        bias_corr = float(np.float32(1.0) - np.power(np.float32(group["betas"][1]), step))
        thr = group["lr"] * lam / ((state["exp_avg_sq"] / bias_corr).sqrt() + eps)
        gamma.copy_(gamma.sign() * (gamma.abs() - thr).clamp(min=0.0))


def param_count(module: nn.Module) -> int:
    """Parameters of ``module`` (the JAX ``param_count`` of its params tree;
    BatchNorm statistics are not counted)."""
    return sum(p.numel() for p in module.parameters())
