"""Flat ``.npz`` (de)serialization of the JAX package's variable trees.

Port of ``mobilenet_yolo_tpu/tools_io.py``: parameters and batch stats
flattened by '/'-joined path under ``params/`` and ``batch_stats/``. The
trees are nested dicts of numpy arrays (walked here without
``jax.tree_util``); ``load_params_npz``'s result feeds
``convert.load_flax_variables``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np


def _flatten(tree: Mapping, prefix: str) -> dict[str, np.ndarray]:
    flat = {}
    for name, value in tree.items():
        key = prefix + str(name)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, key + "/"))
        else:
            flat[key] = np.asarray(value)
    return flat


def save_params_npz(path: str, params: Mapping, batch_stats: Mapping) -> None:
    flat = _flatten(params, "params/")
    flat.update(_flatten(batch_stats, "batch_stats/"))
    np.savez(path, **flat)


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_params_npz(path: str) -> tuple[dict, dict]:
    """Returns (params, batch_stats) nested dicts of numpy arrays."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    tree = _unflatten(flat)
    return tree.get("params", {}), tree.get("batch_stats", {})
