"""The port's front door on the CPU: the infer CLI (the cases of
``tests/test_cli_infer.py``), ``tools_io`` and the ``.npz`` weights path
against the JAX package's, the infer preprocessing against the JAX CLI's,
and the port's ``bench`` in each input and model mode.

Detections follow ``test_torch_predict.py``'s tolerances: ``keep`` exact,
the kept detections within ``atol = rtol = 1e-5``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mobilenet_yolo_tpu import tools_io as jax_tools_io
from mobilenet_yolo_tpu.cli import infer as jax_infer
from mobilenet_yolo_tpu.eval.detector import make_predict_fn as jax_make_predict_fn
from mobilenet_yolo_tpu.models import build_model as jax_build_model
from mobilenet_yolo_tpu_torch import bench, tools_io
from mobilenet_yolo_tpu_torch.cli import infer
from mobilenet_yolo_tpu_torch.config import default_data_yaml, prune_plan
from mobilenet_yolo_tpu_torch.eval import make_predict_fn
from mobilenet_yolo_tpu_torch.models import build_model

from _torch_parity import VOC_CONFIG, jax_init, load_yaml, nhwc_input, perturb
from test_cli_infer import _write_configs, _write_images  # its 3-class 96x96 yamls

TOL = dict(atol=1e-5, rtol=1e-5)
SLIM50 = default_data_yaml("voc/slim50.yaml")


def _args(data_yaml, tmp_path, *extra):
    return infer.get_args(["-y", data_yaml, "--img-size", "96", "--random-weights",
                           "--device", "cpu", "--out-dir", str(tmp_path / "save"), *extra])


def test_single_image(tmp_path, rng, capsys):
    data_yaml = _write_configs(tmp_path)
    _write_images(str(tmp_path / "imgs"), 1, rng)
    out_path = infer.main(_args(data_yaml, tmp_path, "-i", str(tmp_path / "imgs" / "im0.jpg"),
                                "--val-conf", "0.05"))
    assert out_path.endswith("im0_result.jpg") and os.path.isfile(out_path)
    out = capsys.readouterr().out
    assert "model inference time" in out and "on cpu" in out


def test_directory_batched(tmp_path, rng, capsys):
    """5 images at batch 2: three batches (tail padded), every image gets
    its annotated <name>_result.jpg."""
    data_yaml = _write_configs(tmp_path)
    _write_images(str(tmp_path / "imgs"), 5, rng)
    written = infer.main(_args(data_yaml, tmp_path, "-i", str(tmp_path / "imgs"),
                               "--val-conf", "0.05", "--batch-size", "2"))
    assert len(written) == 5
    for i in range(5):
        p = os.path.join(str(tmp_path / "save"), f"im{i}_result.jpg")
        assert os.path.isfile(p)
        with Image.open(p) as im:
            assert im.size == (160, 120)   # original resolution preserved
    assert "img/s warm on cpu" in capsys.readouterr().out


def test_directory_empty_raises(tmp_path):
    data_yaml = _write_configs(tmp_path)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        infer.main(_args(data_yaml, tmp_path, "-i", str(tmp_path / "empty")))


def test_directory_same_stem_no_overwrite(tmp_path, rng):
    """im0.jpg + im0.png must produce two distinct result files."""
    data_yaml = _write_configs(tmp_path)
    d = str(tmp_path / "imgs")
    os.makedirs(d)
    img = rng.integers(0, 255, (60, 80, 3), np.uint8)
    Image.fromarray(img).save(os.path.join(d, "im0.jpg"))
    Image.fromarray(img ^ 255).save(os.path.join(d, "im0.png"))
    written = infer.main(_args(data_yaml, tmp_path, "-i", d, "--val-conf", "0.05",
                               "--batch-size", "2"))
    assert len(written) == 2 and len(set(written)) == 2
    for p in written:
        assert os.path.isfile(p)


class _Captured(Exception):
    pass


def test_infer_preprocesses_as_the_jax_cli(tmp_path, rng, monkeypatch):
    """The image reaches the port's predict as the JAX CLI's ``prep`` makes
    it (resize to --img-size, ``x/255 - 0.5``), and ``make_predict_fn``
    does not normalize it again with the yaml's statistics."""
    data_yaml = _write_configs(tmp_path)
    _write_images(str(tmp_path / "imgs"), 1, rng)
    path = str(tmp_path / "imgs" / "im0.jpg")

    def capture_example(model, checkpoint, example, random_ok=False):
        raise _Captured(np.asarray(example))

    monkeypatch.setattr(jax_infer, "load_variables", capture_example)
    with pytest.raises(_Captured) as jax_x:
        jax_infer.main(jax_infer.get_args(["-y", data_yaml, "-i", path, "--img-size", "64",
                                           "--random-weights"]))
    want = jax_x.value.args[0]

    seen = {}

    def recording_make_predict_fn(model, config, **kwargs):
        seen["kwargs"] = kwargs
        predict = make_predict_fn(model, config, **kwargs)

        def recorded(images, val_conf):
            seen["images"] = images.numpy()
            return predict(images, val_conf)
        return recorded

    monkeypatch.setattr(infer, "make_predict_fn", recording_make_predict_fn)
    infer.main(_args(data_yaml, tmp_path, "-i", path, "--img-size", "64"))
    assert want.shape == seen["images"].shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(seen["images"], want)
    np.testing.assert_array_equal(infer.prep(path, 64)[1], want[0])
    assert not seen["kwargs"].get("normalize", False)
    assert want.min() >= -0.5 and want.max() <= 0.5


def test_load_variables_refuses_a_checkpoint_directory(tmp_path):
    """A directory that holds no checkpoint step is refused (a trainer's
    checkpoint directory is served: ``test_torch_checkpoints.py``)."""
    model = build_model(load_yaml(VOC_CONFIG), device="cpu")
    with pytest.raises(FileNotFoundError, match="no loadable checkpoint"):
        infer.load_variables(model, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        infer.load_variables(model, str(tmp_path / "missing.npz"))
    assert infer.load_variables(model, str(tmp_path), random_ok=True) is model


@pytest.fixture(scope="module")
def voc_variables():
    cfg = load_yaml(VOC_CONFIG)
    return cfg, perturb(jax_init(jax_build_model(cfg), nhwc_input(21)), seed=22, out_std=0.5)


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key])
        else:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tools_io_round_trips_with_jax(writer, voc_variables, tmp_path):
    _, variables = voc_variables
    path = str(tmp_path / "v.npz")
    save = jax_tools_io.save_params_npz if writer == "jax" else tools_io.save_params_npz
    load = tools_io.load_params_npz if writer == "jax" else jax_tools_io.load_params_npz
    save(path, variables["params"], variables["batch_stats"])
    params, batch_stats = load(path)
    _assert_trees_equal(params, variables["params"])
    _assert_trees_equal(batch_stats, variables["batch_stats"])
    with np.load(path) as data:
        assert all(k.startswith(("params/", "batch_stats/")) for k in data.files)


def test_npz_weights_serve_as_in_jax(voc_variables, tmp_path):
    """A ``.npz`` written by JAX ``save_params_npz``: the port's
    ``load_variables`` and JAX's read it, and the two predicts agree."""
    cfg, variables = voc_variables
    path = str(tmp_path / "params.npz")
    jax_tools_io.save_params_npz(path, variables["params"], variables["batch_stats"])
    images = nhwc_input(23)

    jax_model = jax_build_model(cfg)
    jax_vars = jax_infer.load_variables(jax_model, path, jnp.asarray(images))
    want = [np.asarray(w) for w in jax_make_predict_fn(jax_model, cfg)(
        jax_vars, jnp.asarray(images), jnp.float32(0.3))]
    model = infer.load_variables(build_model(cfg, device="cpu"), path)
    dets, keep = (t.numpy() for t in make_predict_fn(model, cfg)(
        torch.from_numpy(images), torch.tensor(0.3)))
    np.testing.assert_array_equal(keep, want[1])
    assert 0 < keep.sum() < (dets[..., 4] > 0.3).sum()
    np.testing.assert_allclose(dets[keep], want[0][keep], **TOL)


@pytest.mark.parametrize("mode", [
    ["--fold-bn"],
    ["--input-dtype", "u8"],
    ["--dtype", "f32", "--input-dtype", "bf16"],   # cast to float32 on the device
    ["--prune-yaml", SLIM50],
])
def test_bench_prints_one_json_line(mode, capsys):
    record = bench.main(["--device", "cpu", "--batch-size", "2", "--img-size", "64",
                         "--iters", "2", *mode])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert set(record) == {"metric", "value", "unit"}
    assert record["value"] > 0 and record["unit"] == "images/sec"
    assert record["metric"].endswith(" on cpu") and "calibrated" in record["metric"]


def test_prune_plan_reads_slim50():
    plan = prune_plan(SLIM50)
    assert plan["backbone_head"] == 1208 and len(plan["backbone_hidden"]) == 17
    assert plan["backbone_hidden"][0] is None and plan["backbone_hidden"][16] == 264


def test_front_door_raises_without_a_card(tmp_path):
    """The bench and the infer CLI run on the card by default and refuse
    the CPU unless asked: no silent fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        bench.main(["--batch-size", "1", "--img-size", "32", "--iters", "1"])
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        infer.main(infer.get_args(["--random-weights", "-i", str(tmp_path)]))
