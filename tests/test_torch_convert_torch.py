"""The port's reference-checkpoint converter
(``mobilenet_yolo_tpu_torch/tools/convert_torch.py``) against the JAX
package's ``tools/convert_torch.py``, on the CPU.

* Every mapping table equals the JAX tool's, key for key.
* ``convert`` (reference state dict -> numpy trees), ``export_state_dict``
  (trees -> reference state dict) and ``load_torch_state_dict`` give the
  JAX tool's arrays, bit for bit, on the same inputs.
* The CLI in both directions: ``--reverse`` from an ``.npz`` and from a
  checkpoint directory of the port's trainer writes the reference's
  per-epoch dict, and ``--torch`` converts it back to the same ``.npz``.
* A round trip through the reference layout leaves the port's forward
  unchanged.
"""

import json
import os

import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu.models import MBv2YOLO as JaxMBv2YOLO
from mobilenet_yolo_tpu.models import MBv3YOLO as JaxMBv3YOLO
from mobilenet_yolo_tpu_torch.convert import load_flax_variables, state_dict_to_flax
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.tools import convert_torch as port
from mobilenet_yolo_tpu_torch.tools_io import _flatten, load_params_npz, save_params_npz
from mobilenet_yolo_tpu_torch.train import create_train_state
from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager
from tools import convert_torch as jax_tool

from _torch_parity import SMALL_YOLO_CONFIG, jax_init, nhwc_input, perturb
from test_reference_parity import ANCHORS_PX, REF, ref_modules  # noqa: F401

MAPPINGS = {
    "mbv2_yolo": lambda m: m.mbv2_yolo_mapping(),
    "mbv2_yolo_seg": lambda m: m.mbv2_yolo_mapping(segmentation=True),
    "mbv2_backbone": lambda m: m.mbv2_backbone_mapping(""),
    "mbv2_backbone_prefixed": lambda m: m.mbv2_backbone_mapping("backbone."),
    "mbv3_backbone": lambda m: m.mbv3_backbone_mapping(""),
    "mbv3_yolo": lambda m: m.mbv3_yolo_mapping(),
}


@pytest.mark.parametrize("name", list(MAPPINGS))
def test_mapping_tables_equal_the_jax_tool(name):
    got, want = MAPPINGS[name](port), MAPPINGS[name](jax_tool)
    assert list(got.items()) == list(want.items())
    assert len(set(got.values())) == len(got)  # one reference key per flax leaf


@pytest.fixture(scope="module")
def trees():
    """JAX's own init of MBv2-YOLO and MBv3-YOLO (64x64, 20 classes),
    perturbed so no two leaves are alike."""
    x = nhwc_input(0)
    return {"mbv2": perturb(jax_init(JaxMBv2YOLO(num_classes=20, num_anchors=3), x), seed=1),
            "mbv3": perturb(jax_init(JaxMBv3YOLO(num_classes=20, num_anchors=3), x), seed=2)}


def _assert_trees_equal(got: dict, want: dict) -> None:
    got, want = _flatten(got, ""), _flatten(want, "")
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("what", ["mbv2", "mbv3"])
def test_convert_and_export_equal_the_jax_tool(trees, what):
    variables = trees[what]
    mapping = port._mapping_for(what if what == "mbv3" else "full")
    sd = port.export_state_dict(variables["params"], variables["batch_stats"], mapping)
    want_sd = jax_tool.export_state_dict(variables["params"], variables["batch_stats"],
                                         jax_tool._mapping_for(what if what == "mbv3" else "full"))
    assert list(sd) == list(want_sd)
    for key in sd:
        np.testing.assert_array_equal(sd[key], want_sd[key], err_msg=key)
    (p_got, s_got), (p_want, s_want) = port.convert(sd, mapping), jax_tool.convert(sd, mapping)
    _assert_trees_equal(p_got, p_want)
    _assert_trees_equal(s_got, s_want)
    _assert_trees_equal(p_got, variables["params"])
    _assert_trees_equal(s_got, variables["batch_stats"])
    with pytest.raises(KeyError):
        port.export_state_dict({}, {}, mapping)


def test_load_torch_state_dict_equals_the_jax_tool(tmp_path):
    rng = np.random.default_rng(0)
    sd = {"module.features.14.conv.0.weight": torch.from_numpy(rng.normal(size=(4, 2, 1, 1))),
          "features.13.conv.0.weight": torch.from_numpy(rng.normal(size=(2, 2, 1, 1))),
          "conv.0.weight": torch.from_numpy(rng.normal(size=(3, 2, 1, 1)))}
    for i, obj in enumerate((sd, {"model": sd}, {"state_dict": sd})):
        path = str(tmp_path / f"ckpt{i}.pth")
        torch.save(obj, path)
        got, want = port.load_torch_state_dict(path), jax_tool.load_torch_state_dict(path)
        assert list(got) == list(want) and "features2.0.conv.0.weight" in got
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


def _port_model(variables: dict) -> torch.nn.Module:
    return load_flax_variables(build_model(SMALL_YOLO_CONFIG | {"yolo": {
        **SMALL_YOLO_CONFIG["yolo"], "num_classes": 20}}, device="cpu"), variables).eval()


def _heads(model, x: np.ndarray) -> dict:
    with torch.inference_mode():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2))


def test_round_trip_through_the_reference_layout_keeps_the_forward(trees):
    model = _port_model(trees["mbv2"])
    variables = state_dict_to_flax(model.state_dict())
    sd = port.export_state_dict(variables["params"], variables["batch_stats"],
                                port.mbv2_yolo_mapping())
    params, stats = port.convert(sd, port.mbv2_yolo_mapping())
    back = _port_model({"params": params, "batch_stats": stats})
    x = nhwc_input(3)
    got, want = _heads(back, x), _heads(model, x)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


@pytest.mark.parametrize("source", ["npz", "checkpoint"])
def test_reverse_cli_and_back(trees, tmp_path, source):
    """``--reverse`` writes the reference's per-epoch dict from an ``.npz``
    or from a port checkpoint directory (its served weights), the JAX tool
    writes the same dict from the same ``.npz``, and ``--torch`` converts it
    back to the tree it came from."""
    variables = trees["mbv2"]
    npz = str(tmp_path / "params.npz")
    save_params_npz(npz, variables["params"], variables["batch_stats"])
    given = npz
    if source == "checkpoint":
        state = create_train_state(_port_model(variables), val_conf=0.2)
        given = str(tmp_path / "ckpt")
        CheckpointManager(given).save(7, state)
    out = str(tmp_path / "exported.pth.tar")
    port.main(["--reverse", "--params", given, "--out", out, "--val-conf", "0.17",
               "--epoch", "42", "--best-acc", "0.71"])
    ckpt = torch.load(out, weights_only=False)
    assert ckpt["epoch"] == 42 and ckpt["conf"] == pytest.approx(0.17)
    assert ckpt["best_acc"] == pytest.approx(0.71) and ckpt["acc"] == pytest.approx(0.71)
    jax_out = str(tmp_path / "jax.pth.tar")
    jax_tool.main(["--reverse", "--params", npz, "--out", jax_out, "--val-conf", "0.17",
                   "--epoch", "42", "--best-acc", "0.71"])
    want = torch.load(jax_out, weights_only=False)
    assert ckpt.keys() == want.keys() and list(ckpt["model"]) == list(want["model"])
    for key, value in want["model"].items():
        torch.testing.assert_close(ckpt["model"][key], value, rtol=0, atol=0, msg=key)

    back = str(tmp_path / "back.npz")
    port.main(["--torch", out, "--out", back])
    params, stats = load_params_npz(back)
    _assert_trees_equal(params, variables["params"])
    _assert_trees_equal(stats, variables["batch_stats"])


def test_reverse_cli_mbv3_and_refusals(trees, tmp_path):
    variables = trees["mbv3"]
    npz = str(tmp_path / "mbv3.npz")
    save_params_npz(npz, variables["params"], variables["batch_stats"])
    out = str(tmp_path / "mbv3.pth.tar")
    port.main(["--reverse", "--what", "mbv3", "--params", npz, "--out", out])
    sd = port.load_torch_state_dict(out)
    assert set(sd) == set(port.mbv3_yolo_mapping().values())
    back = str(tmp_path / "mbv3_back.npz")
    port.main(["--torch", out, "--what", "mbv3", "--out", back])
    params, stats = load_params_npz(back)
    _assert_trees_equal(params, variables["params"])
    _assert_trees_equal(stats, variables["batch_stats"])
    with pytest.raises(SystemExit):
        port.main(["--reverse", "--out", out])                          # no --params
    with pytest.raises(SystemExit):
        port.main(["--reverse", "--what", "backbone", "--params", npz, "--out", out])
    with pytest.raises(SystemExit):
        port.main(["--out", out])                                       # no --torch


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference tree not mounted")
def test_wrap_module_loads_in_the_reference(ref_modules, trees, tmp_path, monkeypatch):
    """``--wrap-module`` pickles the reference's own module around the
    weights (``tests/test_reference_parity.py`` sets up the reference
    package); its state dict holds every exported tensor."""
    import importlib

    import models.mobilenetv2 as ref_mnv2
    monkeypatch.setattr(ref_mnv2, "load_state_dict_from_url", lambda *a, **k: {})
    import models.mbv2_yolo as ref_mbv2_yolo
    importlib.reload(ref_mbv2_yolo)

    variables = trees["mbv2"]
    npz = str(tmp_path / "params.npz")
    save_params_npz(npz, variables["params"], variables["batch_stats"])
    model_yaml = tmp_path / "model.yaml"
    model_yaml.write_text(json.dumps({
        "img_w": 160, "img_h": 160, "iou_weighting": 0.0218,
        "yolo": {"num_classes": 20, "num_anchors": 3, "ignore_thresh": [0.6, 0.55],
                 "iou_thresh": 0.55, "anchors": ANCHORS_PX, "mask": [[0, 1, 2], [3, 4, 5]]}}))
    port.main(["--reverse", "--params", npz, "--out", str(tmp_path / "ref.pth.tar"),
               "--wrap-module", "--model-config", str(model_yaml), "--val-conf", "0.05"])
    net = torch.load(str(tmp_path / "ref_model_best.pth.tar"), weights_only=False)
    exported = port.load_torch_state_dict(str(tmp_path / "ref.pth.tar"))
    state = net.state_dict()
    for key, value in exported.items():
        np.testing.assert_array_equal(state[key].numpy(), value, err_msg=key)
