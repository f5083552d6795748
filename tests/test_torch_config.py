"""The port's two-level yaml config against the JAX package's.

The bundled yamls are byte-identical copies; ``load_config``,
``apply_overrides`` and ``validate_model_config`` give the same dicts and
the same errors on the same inputs.
"""

import copy
import filecmp

import pytest

from mobilenet_yolo_tpu import config as jax_config
from mobilenet_yolo_tpu_torch import config

from _torch_parity import REPO

YAMLS = ["voc_data.yaml", "voc/config.yaml", "voc/slim50.yaml", "bdd100k_data.yaml",
         "bdd100k/config.yaml"]


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_copies_are_byte_identical(name):
    port = REPO / "mobilenet_yolo_tpu_torch" / "configs" / name
    assert filecmp.cmp(port, REPO / "mobilenet_yolo_tpu" / "configs" / name, shallow=False)
    assert config.load_yaml(str(port)) == jax_config.load_yaml(str(port))


@pytest.mark.parametrize("name", ["voc_data.yaml", "bdd100k_data.yaml"])
def test_load_config_matches_jax(name):
    got = config.load_config(config.default_data_yaml(name))
    want = jax_config.load_config(jax_config.default_data_yaml(name))
    assert got.data_yaml_path.startswith(str(REPO / "mobilenet_yolo_tpu_torch" / "configs"))
    assert got.data == want.data and got.model == want.model
    for prop in ("classes", "num_classes", "img_size", "anchors", "masks",
                 "segmentation_enabled", "seg_num_classes"):
        assert getattr(got, prop) == getattr(want, prop), prop
    if name == "voc_data.yaml":
        assert got.model == config.VOC_CONFIG
        assert got.classes[0] == "background" and got.num_classes == 20
    else:
        assert got.seg_num_classes == 2 and got.segmentation_enabled


OVERRIDES = [
    {"ignore_thresh_1": 0.4, "iou_thresh": 0.3, "mosaic_num": [1], "learning_rate": 1e-3},
    {"ignore_thresh_2": 0.7, "expand_scale": 1.5, "iou_weighting": None},
    {},
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_apply_overrides_matches_jax(overrides):
    base = copy.deepcopy(config.VOC_CONFIG)
    got = config.apply_overrides(base, overrides)
    assert got == jax_config.apply_overrides(base, overrides)
    assert base == config.VOC_CONFIG  # the input is not mutated
    got = config.load_config(config.default_data_yaml(), overrides)
    want = jax_config.load_config(jax_config.default_data_yaml(), overrides)
    assert got.model == want.model


def _bad_mask(cfg):
    cfg["yolo"]["mask"] = [[0, 1, 6], [3, 4, 5]]


def _bad_thresh(cfg):
    cfg["yolo"]["ignore_thresh"] = [0.5]


def _bad_size(cfg):
    cfg["train_img_size"] = [[352, 350]]


@pytest.mark.parametrize("breaks", [None, _bad_mask, _bad_thresh, _bad_size])
def test_validate_model_config_matches_jax(breaks):
    cfg = copy.deepcopy(config.VOC_CONFIG)
    if breaks is None:
        assert config.validate_model_config(cfg) is None
        assert jax_config.validate_model_config(cfg) is None
        return
    breaks(cfg)
    with pytest.raises(ValueError) as want:
        jax_config.validate_model_config(cfg)
    with pytest.raises(ValueError, match=str(want.value)):
        config.validate_model_config(cfg)
