"""The BDD100K multi-task path (detection and drivable-area segmentation) of
the port against the JAX package's, on the CPU.

One fabricated BDD-style tree (``tools/make_fabricated_bdd.py``: per-image
COCO JSON whose class map drops 2 of 5 classes, single-channel seg PNGs)
goes through both dataset builders, which must write byte-identical records
(their ``meta.json`` differ in the builder's keys, which only the port's
keeps);
both ``Loader(device_geometry=True)``s over those shards, which must stage
bit-identical seg slots; and one loader batch through both segmentation
geometry steps in float64.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mobilenet_yolo_tpu.data import dataset_builder as j_builder
from mobilenet_yolo_tpu.data import pipeline as j_pipeline
from mobilenet_yolo_tpu.data import records as j_records
from mobilenet_yolo_tpu.models import MBv2YOLO as JaxMBv2YOLO
from mobilenet_yolo_tpu.train import state as j_state
from mobilenet_yolo_tpu.train import step as j_step
from mobilenet_yolo_tpu_torch.convert import load_flax_variables, state_dict_to_flax
from mobilenet_yolo_tpu_torch.data import dataset_builder
from mobilenet_yolo_tpu_torch.data.pipeline import DetectionDataset, Loader
from mobilenet_yolo_tpu_torch.data.records import RecordReader
from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
from mobilenet_yolo_tpu_torch.train import (GEOMETRY_BATCH_KEYS, create_train_state,
                                            make_geometry_train_step)

from _torch_parity import (SMALL_YOLO_CONFIG, assert_builder_meta, jax_train_state, perturb,
                           state_dict_of)

REPO = Path(__file__).resolve().parent.parent
SPLITS = ("trainval_dataset_path", "test_dataset_path")
SEG_CONFIG = {**SMALL_YOLO_CONFIG, "seg": {"num_classes": 2}}


@pytest.fixture(scope="module")
def bdd_shards(tmp_path_factory):
    """A fabricated BDD tree of 6 train and 2 test images (seed 3), built
    by the JAX builder under ``jax/`` and by the port's under ``port/``.
    Returns the tree's root."""
    root = tmp_path_factory.mktemp("fabbdd")
    subprocess.run([sys.executable, str(REPO / "tools" / "make_fabricated_bdd.py"),
                    "--root", str(root), "--train", "6", "--test", "2", "--seed", "3"],
                   check=True, capture_output=True, timeout=120)
    data = yaml.safe_load((root / "data.yaml").read_text())
    for tag, build in (("jax", j_builder.build_dataset), ("port", dataset_builder.build_dataset)):
        for split in SPLITS:
            data[split]["lmdb"] = str(root / tag / split)
        path = root / f"{tag}.yaml"
        path.write_text(yaml.safe_dump(data))
        build(str(path), log=lambda *a: None)
    return root


def test_builders_write_identical_bdd_shards(bdd_shards):
    """Both builders on the COCO-JSON tree with its class map and seg PNGs:
    ``data.bin`` and ``index.bin`` byte-identical, ``meta.json`` key for
    key but for the builder's keys, which only the port's keeps (the JAX
    writer rewrites it without them; ``assert_builder_meta``); the records
    hold the remapped labels (1-3) and a single-channel seg PNG each."""
    classes = ["background"] + list(yaml.safe_load(
        (bdd_shards / "data.yaml").read_text())["classes"]["map"])
    for split, n in zip(SPLITS, (6, 2)):
        for name in ("data.bin", "index.bin"):
            want = (bdd_shards / "jax" / split / name).read_bytes()
            assert (bdd_shards / "port" / split / name).read_bytes() == want, (split, name)
        assert_builder_meta(bdd_shards / "port" / split, bdd_shards / "jax" / split, classes,
                            True)
        r = RecordReader(str(bdd_shards / "port" / split))
        assert len(r) == n
        labels = np.concatenate([r[i].labels for i in range(n)])
        assert set(labels[:, 0].astype(int)) <= {1, 2, 3} and len(labels)
        assert all(r[i].seg_bytes for i in range(n))


PORT = (DetectionDataset, Loader, RecordReader)
JAX = (j_pipeline.DetectionDataset, j_pipeline.Loader, j_records.RecordReader)


def _loader_batches(package, shard: str, mosaic) -> list[dict]:
    """The first batch of two epochs of a package's seg geometry loader
    (``package``: its dataset, loader and reader classes), copied out of
    the loader's buffers."""
    dataset_cls, loader_cls, reader_cls = package
    ds = dataset_cls(reader_cls(shard), phase="train", expand_scale=1.3, has_seg=True,
                     seg_num_classes=2, apply_noise=False, apply_photometric=False)
    loader = loader_cls(ds, 4, [[64, 64]], [0.5] * 3, [1.0] * 3, mosaic_num=mosaic, max_gt=10,
                        prefetch=0, device_geometry=True, seed=5)
    return [{k: v.copy() if isinstance(v, np.ndarray) else v for k, v in next(iter(loader)).items()}
            for _ in range(2)]


@pytest.mark.parametrize("mosaic", [[1], [1, 4]], ids=["single", "mosaic"])
def test_seg_geometry_loader_matches_jax(bdd_shards, mosaic):
    """The port's ``Loader(device_geometry=True, has_seg=True)`` over the
    port-built shard against the JAX ``Loader`` over the JAX-built one:
    ``seg_slots``, ``seg_active`` and every geometry key bit-identical."""
    shard = SPLITS[0]
    port = _loader_batches(PORT, str(bdd_shards / "port" / shard), mosaic)
    ref = _loader_batches(JAX, str(bdd_shards / "jax" / shard), mosaic)
    for got, want in zip(port, ref, strict=True):
        assert got["seg_slots"].dtype == np.uint8 and got["seg_active"].any()
        for key in ("seg_active", *(k for k in GEOMETRY_BATCH_KEYS if k != "slots"), "gt",
                    "n_gt"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        # an inactive slot holds whatever its buffer held before
        for key, active in (("seg_slots", "seg_active"), ("slots", "active")):
            mask = want[active]
            np.testing.assert_array_equal(got[key][mask], want[key][mask], err_msg=key)


def _seg_pair():
    """The width-0.35 MBv2-YOLO with a 2-class seg head: seeded weights,
    perturbed, as float64 flax variables; the JAX model computing in
    float64, and the port holding them in float64."""
    init = MBv2YOLO(num_classes=3, num_anchors=3, seg_num_classes=2, width_mult=0.35,
                    generator=torch.Generator().manual_seed(2))
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       perturb(state_dict_to_flax(init.state_dict()), seed=2))
    jm = JaxMBv2YOLO(num_classes=3, num_anchors=3, seg_num_classes=2, width_mult=0.35,
                     dtype=jnp.float64)
    port = MBv2YOLO(num_classes=3, num_anchors=3, seg_num_classes=2, width_mult=0.35,
                    dtype=torch.float64)
    return variables, jm, load_flax_variables(port, variables)


def test_seg_geometry_step_matches_jax(bdd_shards):
    """One loader batch of the fabricated tree (64x64, 1- and 4-tile
    images, noise off) through the port's segmentation geometry step and
    the JAX one, plain ops, float64 end to end, AdamW on both sides: the
    loss, ``seg_obj`` and ``seg_no_obj`` to rtol 1e-6 and the parameters
    after the step to atol 1e-5 (``test_loader_fed_geometry_step_matches_jax``'s
    tolerances). As there, the contrast and hue steps and the mean fills
    are taken out of the batch."""
    batch = _loader_batches(PORT, str(bdd_shards / "port" / SPLITS[0]), [1, 4])[0]
    batch["jitter_op"][np.isin(batch["jitter_op"], (1, 3))] = -1
    batch["fill_from_mean"][:] = False
    keys = (*GEOMETRY_BATCH_KEYS, "seg_slots", "seg_active")
    variables, jm, model = _seg_pair()
    with jax.enable_x64(True):
        tx = j_state.make_optimizer(7e-4, 4e-4)
        step = j_step.make_geometry_train_step(jm, SEG_CONFIG, tx, segmentation=True,
                                               fused_aug=False)
        new_state, want = step(jax_train_state(variables, tx),
                               *(jnp.asarray(batch[k]) for k in keys),
                               jnp.asarray(batch["gt"]), jnp.asarray(batch["n_gt"]),
                               jax.random.PRNGKey(3), out_hw=(64, 64))
        want = {k: float(want[k]) for k in ("loss", "seg_obj", "seg_no_obj")}

    port_step = make_geometry_train_step(model, SEG_CONFIG, segmentation=True, fused_aug=False,
                                         dtype=torch.float64)
    _, got = port_step(create_train_state(model), *(torch.from_numpy(batch[k]) for k in keys),
                       torch.from_numpy(batch["gt"]), torch.from_numpy(batch["n_gt"]), 3,
                       out_hw=batch["out_size"])
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), value, rtol=1e-6, err_msg=key)
    assert want["seg_obj"] != want["seg_no_obj"]
    params = dict(model.named_parameters())
    for key, value in state_dict_of("params", new_state.params).items():
        np.testing.assert_allclose(params[key].detach().numpy(), value, atol=1e-5, err_msg=key)
