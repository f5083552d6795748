"""Helpers shared by the ``test_torch_*.py`` parity tests.

Weights come from the JAX package's own init, are perturbed in numpy so
the comparison has something to see (BatchNorm statistics away from
(0, 1), head logits spread out of the near-tie an N(0, 0.01) ``out`` conv
gives), and reach the port through ``mobilenet_yolo_tpu_torch.convert``.
"""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import torch
import yaml

from mobilenet_yolo_tpu_torch.convert import load_flax_variables

REPO = Path(__file__).resolve().parent.parent
VOC_CONFIG = REPO / "mobilenet_yolo_tpu" / "configs" / "voc" / "config.yaml"
SLIM50_CONFIG = REPO / "mobilenet_yolo_tpu" / "configs" / "voc" / "slim50.yaml"

# the parity tests stay small: a few CPU threads, 64x64 input, batch 2
torch.set_num_threads(2)


def load_yaml(path: Path) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def nhwc_input(seed: int, shape=(2, 64, 64, 3)) -> np.ndarray:
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)


def jax_init(module, x: np.ndarray, seed: int = 0) -> dict:
    """The JAX module's own init, as nested numpy dicts."""
    variables = jax.jit(
        lambda x: module.init(jax.random.PRNGKey(seed), x, train=False))(x)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def jax_apply(module, variables: dict, x: np.ndarray):
    out = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x)
    return jax.tree_util.tree_map(np.asarray, out)


def perturb(variables: dict, seed: int, out_std: float = 0.05) -> dict:
    """Random BatchNorm affine/statistics, and ``out`` conv kernels redrawn
    at ``out_std`` (see the module docstring)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        res = {}
        for name, value in tree.items():
            if isinstance(value, dict):
                res[name] = walk(value, path + (name,))
                continue
            shape, leaf = value.shape, (path[-1], name)
            if leaf == ("bn", "scale"):
                value = rng.uniform(0.8, 1.2, shape)
            elif leaf in (("bn", "bias"), ("bn", "mean")):
                value = rng.normal(0.0, 0.05, shape)
            elif leaf == ("bn", "var"):
                value = rng.uniform(0.8, 1.2, shape)
            elif leaf == ("out", "kernel"):
                value = rng.normal(0.0, out_std, shape)
            elif leaf == ("out", "bias"):
                value = rng.normal(0.0, 0.1, shape)
            res[name] = np.asarray(value, np.float32)
        return res

    return walk(variables, ())


def port_module(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    return load_flax_variables(module, variables).eval()


def to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()
