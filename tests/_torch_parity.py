"""Helpers shared by the ``test_torch_*.py`` parity tests.

Weights come from the JAX package's own init, are perturbed in numpy so
the comparison has something to see (BatchNorm statistics away from
(0, 1), head logits spread out of the near-tie an N(0, 0.01) ``out`` conv
gives), and reach the port through ``mobilenet_yolo_tpu_torch.convert``.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from mobilenet_yolo_tpu.models import MBv2YOLO as JaxMBv2YOLO
from mobilenet_yolo_tpu.train import state as j_state
from mobilenet_yolo_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from mobilenet_yolo_tpu_torch.data.records import RecordReader
from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO

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


# the small YOLO head config the JAX package's own train tests use
# (tests/test_pallas_aug.py): 3 classes, two heads of 3 anchors
SMALL_YOLO_CONFIG = {
    "iou_weighting": 0.02,
    "normalize": {"mean": [0.5] * 3, "std": [1.0] * 3},
    "yolo": {
        "num_classes": 3, "num_anchors": 3,
        "ignore_thresh": [0.6, 0.55], "iou_thresh": 0.55,
        "anchors": [[18, 22], [24, 24], [30, 28], [6, 8], [10, 12], [14, 10]],
        "mask": [[0, 1, 2], [3, 4, 5]],
    },
}


def padded_gt(rng: np.random.Generator, n_gt, t: int, num_classes: int = 3):
    """(B, T, 5) GT rows (label 1-indexed, cx, cy, w, h) with random
    garbage, never zeros, in the padded rows past ``n_gt``."""
    b = len(n_gt)
    gt = np.zeros((b, t, 5), np.float32)
    gt[..., 0] = rng.integers(1, num_classes + 1, (b, t))
    gt[..., 1:3] = rng.uniform(0.1, 0.9, (b, t, 2))
    gt[..., 3:5] = rng.uniform(0.05, 0.6, (b, t, 2))
    return gt, np.asarray(n_gt, np.int32)


def geometry_batch(rng: np.random.Generator, b: int, s: int) -> dict:
    """A ``Loader(device_geometry=True)``-contract batch from the host
    planner, noise gates off: even images single-tile, odd ones 4-tile
    mosaics (mean fills, flips, crops)."""
    from mobilenet_yolo_tpu.data.geometry import GeometryPlanner
    from mobilenet_yolo_tpu.train.step import GEOMETRY_BATCH_KEYS

    planner = GeometryPlanner(stage_size=s, apply_noise=False)
    plans = []
    for i in range(b):
        sources = [(rng.integers(0, 255, (40, 50, 3), np.uint8),
                    np.asarray([[5, 5, 30, 30]], np.float32), np.float32([1.0]),
                    np.float32([0.0])) for _ in range(1 if i % 2 == 0 else 4)]
        plans.append(planner.plan_group(sources, rng))
    batch = {k: np.stack([getattr(p, k) for p in plans]) for k in GEOMETRY_BATCH_KEYS}
    batch["gt"] = np.zeros((b, 8, 5), np.float32)
    batch["n_gt"] = np.zeros((b,), np.int32)
    for i, p in enumerate(plans):
        rows = p.labels[:8]
        batch["gt"][i, :len(rows)] = rows[:, :5]
        batch["n_gt"][i] = len(rows)
    return batch


def state_dict_of(collection: str, tree: dict) -> dict:
    """A JAX ``params`` / ``batch_stats`` (or gradient) tree as numpy arrays
    under the port's state-dict keys."""
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return {k: v.numpy() for k, v in flax_to_state_dict({collection: tree}).items()}


# ------------------------------------------- float64 whole-step comparisons


def width035_variables64() -> dict:
    """The JAX init of the width-0.35 MBv2-YOLO (3 classes), perturbed (BN
    statistics away from (0, 1), ``out`` kernels spread), as float64 numpy."""
    jm = JaxMBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  perturb(jax_init(jm, np.zeros((1, 32, 32, 3), np.float32)),
                                          seed=1))


def float64_pair(variables: dict):
    """The JAX model computing in float64, and the port holding the same
    weights in float64."""
    jm = JaxMBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35, dtype=jnp.float64)
    port = MBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35, dtype=torch.float64)
    return jm, load_flax_variables(port, variables)


def jax_train_state(variables: dict, tx):
    return j_state.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), epoch=jnp.int32(0),
        best_acc=jnp.float32(0), val_conf=jnp.float32(0.1), batch_idx=jnp.int32(0))


def assert_bn_stats_match(model: torch.nn.Module, new_stats) -> None:
    """BN statistics after the step: float64 forwards, to 1e-9."""
    got = model.state_dict()
    for key, want in state_dict_of("batch_stats", new_stats).items():
        np.testing.assert_allclose(got[key].numpy(), want, rtol=1e-9, atol=1e-12, err_msg=key)


# the builder's keys, which the port's ``meta.json`` keeps and the JAX
# package's loses (its ``with`` block rewrites ``meta.json`` after the
# builder's ``close(meta)``; the JAX package is not edited)
BUILDER_META_KEYS = ("classes", "total_boxes", "segmentation")


def assert_builder_meta(port: Path, jax_shard: Path, classes: list, segmentation: bool) -> None:
    """``meta.json`` of a port-built shard: every key of the JAX-built one's
    equal, and the builder's keys (absent from the JAX one) with the
    builder's values: the classes with the background, every record's
    boxes counted, the seg flag."""
    got = json.loads((port / "meta.json").read_text())
    want = json.loads((jax_shard / "meta.json").read_text())
    assert not set(want) & set(BUILDER_META_KEYS)
    assert {k: got[k] for k in want} == want
    r = RecordReader(str(port))
    assert {k: got[k] for k in BUILDER_META_KEYS} == {
        "classes": classes, "total_boxes": sum(len(r[i].labels) for i in range(len(r))),
        "segmentation": segmentation}
    assert set(got) == set(want) | set(BUILDER_META_KEYS)
