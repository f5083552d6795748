"""The port's serving slice against the JAX package's, on the CPU.

``decode_predictions`` on identical head logits, then the whole
``make_predict_fn`` (forward -> decode -> top-K -> NMS) on identical images
and weights, against JAX ``make_predict_fn`` on its XLA scan (the Pallas
scan cannot run outside a TPU there, and ``tests/test_pallas_nms.py`` pins
the two bit-equal). ``keep`` must match exactly; the kept detections match
within ``atol = rtol = 1e-5``: boxes and scores go through exp and sigmoid,
whose float32 implementations differ in the last bits between XLA and
torch. The model's ``out`` convs are redrawn at std 0.5 so the scores are
spread and the top-K order is not decided by rounding noise.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu.eval.detector import make_predict_fn as jax_make_predict_fn
from mobilenet_yolo_tpu.models import build_model as jax_build_model
from mobilenet_yolo_tpu.ops.decode import decode_predictions as jax_decode
from mobilenet_yolo_tpu.ops.decode import reshape_head as jax_reshape_head
from mobilenet_yolo_tpu_torch.eval import make_predict_fn
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.ops.decode import decode_predictions, reshape_head

from _torch_parity import REPO, VOC_CONFIG, jax_init, load_yaml, nhwc_input, perturb, port_module

TOL = dict(atol=1e-5, rtol=1e-5)


def test_decode_matches_jax():
    rng = np.random.default_rng(0)
    head = rng.normal(0.0, 2.0, (2, 4, 5, 75)).astype(np.float32)
    head[0, 0, 0, 2:4] = [40.0, -40.0]  # beyond WH_CLIP on both sides
    anchors = rng.uniform(0.05, 0.5, (3, 2)).astype(np.float32)
    want = np.asarray(jax_decode(jax_reshape_head(jnp.asarray(head), 3), jnp.asarray(anchors)))
    got = decode_predictions(reshape_head(torch.from_numpy(head), 3), torch.from_numpy(anchors))
    assert got.shape == want.shape == (2, 4 * 5 * 3, 7)
    np.testing.assert_array_equal(got[..., 6].numpy(), want[..., 6])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="anchors"):
        reshape_head(torch.zeros(1, 2, 2, 74), 3)


@pytest.fixture(scope="module")
def seg_setup():
    cfg = dict(load_yaml(VOC_CONFIG), seg={"num_classes": 4})
    variables = perturb(jax_init(jax_build_model(cfg), nhwc_input(5)), seed=6, out_std=0.5)
    return cfg, variables


def _plain(cfg, variables):
    cfg = {k: v for k, v in cfg.items() if k != "seg"}
    variables = {col: {k: v for k, v in tree.items() if not k.startswith("seg_")}
                 for col, tree in variables.items()}
    return cfg, variables


@pytest.mark.parametrize("variant", ["f32", "u8_normalize", "seg"])
def test_predict_matches_jax(variant, seg_setup):
    cfg, variables = seg_setup if variant == "seg" else _plain(*seg_setup)
    normalize = variant == "u8_normalize"
    if normalize:
        images = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    else:
        images = nhwc_input(7)
    val_conf = 0.3

    jax_model = jax_build_model(cfg)
    want = jax_make_predict_fn(jax_model, cfg, normalize=normalize)(
        variables, jnp.asarray(images), jnp.float32(val_conf))
    want = [np.asarray(w) for w in want]
    predict = make_predict_fn(port_module(build_model(cfg, device="cpu"), variables), cfg,
                              normalize=normalize)
    got = [g.numpy() for g in predict(torch.from_numpy(images), torch.tensor(val_conf))]

    assert len(got) == len(want) == (3 if variant == "seg" else 2)
    dets, keep = got[0], got[1]
    assert dets.shape == (2, 60, 7) and keep.shape == (2, 60)  # N = (2*2 + 4*4) * 3 at 64x64
    np.testing.assert_array_equal(keep, want[1])
    assert 0 < keep.sum() < (dets[..., 4] > val_conf).sum()  # NMS did suppress
    np.testing.assert_allclose(dets[keep], want[0][keep], **TOL)
    if variant == "seg":
        assert got[2].shape == want[2].shape == (2, 4, 4, 4)
        np.testing.assert_allclose(got[2], want[2], **TOL)


def test_predict_bf16_close_to_f32(seg_setup):
    """bf16 autocast serving against float32 on the same weights: bf16 keeps
    8 bits of mantissa, so boxes and scores in [0, 1] move by ~1e-2."""
    cfg, variables = _plain(*seg_setup)
    model = port_module(build_model(cfg, device="cpu"), variables)
    images, val_conf = torch.from_numpy(nhwc_input(8)), torch.tensor(0.3)
    dets32, _ = make_predict_fn(model, cfg)(images, val_conf)
    dets16, keep16 = make_predict_fn(model, cfg, dtype=torch.bfloat16)(images, val_conf)
    assert dets16.dtype == torch.float32 and keep16.any()
    # the top-K order can swap where bf16 moves near-equal scores, so
    # compare the sorted score lists
    np.testing.assert_allclose(dets16[..., 4].sort(-1).values.numpy(),
                               dets32[..., 4].sort(-1).values.numpy(), atol=3e-2)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mobilenet_yolo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 15, names\n"
        "new = {'data.records', 'data.augment', 'data.mosaic', 'data.geometry',\n"
        "       'data.pipeline', 'data.synthetic', 'data.dataset_builder', 'data.workers',\n"
        "       'cli.build_dataset', 'train.loop', 'train.checkpoints', 'train.hpo',\n"
        "       'cli.train', 'cli.eval', 'parallel.mesh', 'utils.meters', 'utils.logger',\n"
        "       'utils.tb_writer', 'hpo.random_search'}\n"
        "assert {pkg.__name__ + '.' + m for m in new} <= set(names), names\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', 'grain', 'mobilenet_yolo_tpu')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
