"""The two-level YAML config and the VOC contract as plain dicts.

Port of ``mobilenet_yolo_tpu/config.py:38-148``: a *data yaml* (dataset
paths, class map, segmentation flags) points at a *model yaml* (image
size, the multiscale buckets, the YOLO head) through
``model_config_path``; flat overrides (CLI flags, HPO parameters) are
spliced on top with the reference's key names. The bundled yamls under
``configs/`` are byte-identical copies of the JAX package's.

``VOC_CONFIG`` holds the values of ``configs/voc/config.yaml`` (the
reference's ``models/voc/config.yaml``), so the port's scripts and tools
read one copy without a yaml parser. ``tests/test_torch_tools.py`` holds
them equal to the file. PyYAML is imported only where a yaml is read.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from typing import Any

VOC_CONFIG = {
    "img_h": 352,
    "img_w": 352,
    "batch_size": 32,
    "train_img_size": [[352, 352], [320, 320], [288, 288], [384, 384], [416, 416]],
    "expand_scale": 2.1610954191879452,
    "mosaic_num": [1, 4],
    "iou_weighting": 0.021830872589525777,
    "normalize": {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]},
    "yolo": {
        "num_classes": 20,
        "num_anchors": 3,
        "ignore_thresh": [0.6076333316652263, 0.5623606200028424],
        "iou_thresh": 0.5497280113447018,
        "anchors": [[143, 265], [153, 121], [280, 279], [20, 37], [49, 94], [73, 201]],
        "classes": 20,
        "mask": [[0, 1, 2], [3, 4, 5]],
    },
}

# the multiscale training buckets, smallest first
TRAIN_BUCKETS = tuple(sorted(h for h, _ in VOC_CONFIG["train_img_size"]))

# Overrides the reference splices into the model config (train.py:69-80).
_MODEL_OVERRIDE_KEYS = {
    "ignore_thresh_1": ("yolo", "ignore_thresh", 0),
    "ignore_thresh_2": ("yolo", "ignore_thresh", 1),
    "iou_thresh": ("yolo", "iou_thresh"),
    "expand_scale": ("expand_scale",),
    "mosaic_num": ("mosaic_num",),
    "iou_weighting": ("iou_weighting",),
}


def load_yaml(path: str) -> dict:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


def prune_plan(path: str) -> dict:
    """The ``prune:`` widths of a model yaml (``tools/prune.py``'s plan,
    e.g. ``configs/voc/slim50.yaml``), as ``build_model`` takes them under
    the model dict's ``prune`` key; empty widths without a plan."""
    plan = load_yaml(path).get("prune") or {}
    hidden = plan.get("backbone_hidden")
    return {"backbone_hidden": list(hidden) if hidden else None,
            "backbone_head": plan.get("backbone_head")}


def default_data_yaml(name: str = "voc_data.yaml") -> str:
    """Absolute path of a bundled config (works from any cwd)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", name)


@dataclass
class Config:
    """Merged view over a (data yaml, model yaml) pair."""

    data: dict = field(default_factory=dict)
    model: dict = field(default_factory=dict)
    data_yaml_path: str = ""
    model_yaml_path: str = ""

    @property
    def classes(self) -> list[str]:
        """Class names *with* the background class at index 0.

        The reference inserts 'background' in front of the data-yaml map
        (train.py:57-58), making stored labels 1-indexed.
        """
        names = list(self.data["classes"]["map"])
        if not names or names[0] != "background":
            names = ["background"] + names
        return names

    @property
    def num_classes(self) -> int:
        return int(self.model["yolo"]["num_classes"])

    @property
    def img_size(self) -> tuple[int, int]:
        return int(self.model["img_w"]), int(self.model["img_h"])

    @property
    def anchors(self) -> list[list[float]]:
        return [list(a) for a in self.model["yolo"]["anchors"]]

    @property
    def masks(self) -> list[list[int]]:
        return [list(m) for m in self.model["yolo"]["mask"]]

    @property
    def segmentation_enabled(self) -> bool:
        return bool(self.data.get("segmentation_enable", False))

    @property
    def seg_num_classes(self) -> int:
        if "seg" in self.model:
            return int(self.model["seg"]["num_classes"])
        return int(self.data.get("segmentation_num_classes", 0))


def apply_overrides(model_cfg: dict, overrides: dict[str, Any]) -> dict:
    """Splice flat override keys into a model config (reference train.py:69-80).

    Unknown keys are ignored here (they may be trainer-level flags such as
    learning_rate / weight_decay, consumed by the training loop).
    """
    cfg = copy.deepcopy(model_cfg)
    for key, value in overrides.items():
        if value is None or key not in _MODEL_OVERRIDE_KEYS:
            continue
        path = _MODEL_OVERRIDE_KEYS[key]
        node = cfg
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = value
    return cfg


def validate_model_config(cfg: dict) -> None:
    yolo = cfg["yolo"]
    n_anchor = len(yolo["anchors"])
    for m in yolo["mask"]:
        for idx in m:
            if not 0 <= idx < n_anchor:
                raise ValueError(f"anchor mask index {idx} out of range 0..{n_anchor-1}")
    if len(yolo["ignore_thresh"]) != len(yolo["mask"]):
        raise ValueError("ignore_thresh must have one entry per head")
    if "train_img_size" in cfg:
        for w, h in cfg["train_img_size"]:
            if w % 32 or h % 32:
                raise ValueError("train_img_size entries must be multiples of 32")


def load_config(data_yaml: str, overrides: dict[str, Any] | None = None) -> Config:
    """Load the two-level config as the reference's train.py does."""
    data_cfg = load_yaml(data_yaml)
    model_path = data_cfg["model_config_path"]
    if not os.path.isabs(model_path):
        # resolve relative to the data yaml first, then cwd (reference uses cwd)
        cand = os.path.join(os.path.dirname(os.path.abspath(data_yaml)), model_path)
        for base_cand in (cand, model_path):
            if os.path.isfile(base_cand):
                model_path = base_cand
                break
    model_cfg = load_yaml(model_path)
    if overrides:
        model_cfg = apply_overrides(model_cfg, overrides)
    validate_model_config(model_cfg)
    return Config(data=data_cfg, model=model_cfg,
                  data_yaml_path=data_yaml, model_yaml_path=model_path)
