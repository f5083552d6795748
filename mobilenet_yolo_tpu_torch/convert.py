"""JAX package variables -> the port's torch weights, mapped by flax path.

The JAX package keeps its variables as nested dicts ``{"params": ...,
"batch_stats": ...}`` (``mobilenet_yolo_tpu/models/layers.py:75-92`` names
the leaves). The port's modules carry the flax module names, so a flax path
``backbone/block1/expand/conv/kernel`` becomes the torch key
``backbone.block1.expand.conv.weight``. The rules, generic over the path:

* ``params`` ``kernel`` -> ``weight``; a 4-d HWIO kernel becomes OIHW
  (``transpose(3, 2, 0, 1)``), which turns a depthwise ``(3, 3, 1, C)``
  kernel into ``(C, 1, 3, 3)``;
* ``params`` BN ``scale``/``bias`` -> ``weight``/``bias``, conv ``bias`` ->
  ``bias``;
* ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
* every BN's ``num_batches_tracked`` is the one key the converter fills
  itself (zero), and the load is ``strict=True``.

``tools/convert_torch.py`` stays the route to and from the upstream
reference's own key layout; this module serves the port only.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for name, value in tree.items():
        path = prefix + (str(name),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _torch_key(path: tuple[str, ...], leaves: dict[str, str]) -> str:
    if path[-1] not in leaves:
        raise KeyError(f"no torch counterpart for flax leaf {'/'.join(path)!r}")
    return ".".join(path[:-1] + (leaves[path[-1]],))


def flax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """Map ``{"params", "batch_stats"}`` numpy trees to torch state_dict
    entries (CPU tensors); ``num_batches_tracked`` is left to the loader."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    state: dict[str, torch.Tensor] = {}
    for collection, leaves in (("params", _PARAM_LEAVES),
                               ("batch_stats", _STAT_LEAVES)):
        for path, value in _flatten(variables.get(collection, {})):
            arr = np.asarray(value)
            if path[-1] == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            key = _torch_key(path, leaves)
            if key in state:
                raise KeyError(f"two flax leaves map to torch key {key!r}")
            state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load JAX package variables into ``module`` with ``strict=True``.

    Values are copied into the module's own parameters, so its device,
    dtype and memory format are kept. Returns ``module``.
    """
    state = flax_to_state_dict(variables)
    for key in module.state_dict():
        if key.endswith("num_batches_tracked"):
            if key in state:
                raise KeyError(f"flax variables cannot carry {key!r}")
            state[key] = torch.zeros((), dtype=torch.long)
    module.load_state_dict(state, strict=True)
    return module
