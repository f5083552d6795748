"""The port's training loop (``mobilenet_yolo_tpu_torch/train/loop.py``) on
the CPU: against the JAX ``Trainer`` and on its own.

* The JAX ``Trainer`` and the port's, from the same weights (drawn in
  numpy onto the JAX model's variable tree and mapped to the port through
  ``convert``; float64 on both sides), on the same ``Loader`` batches (each
  package's own loader over one shard: bit-identical batches,
  ``test_torch_data.py``) in plain mode, for 2 epochs of 2 steps with
  ``eval_every=2``: every step's loss, each epoch's LR, which epochs
  evaluate, the ``val_conf`` trajectory and the mAP, the ``log.txt`` rows
  (not the Time column), the checkpoint steps kept and the best step.
  Tolerances are stated at ``test_fit_matches_jax``.
* An eval between two train steps (EMA on) leaves the next step unchanged,
  bit for bit: the model is evaluated in eval mode, on the average, and
  the live parameters come back in place.
* The mirrors of ``tests/test_trainer_fit.py``. The checkpoint side (the
  mid-epoch resume, EMA across a resume) is ``test_torch_checkpoints.py``.
"""

import glob
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu.data import pipeline as j_pipeline
from mobilenet_yolo_tpu.data import records as j_records
from mobilenet_yolo_tpu.models import MBv2YOLO as JaxMBv2YOLO
from mobilenet_yolo_tpu.train import checkpoints as j_checkpoints
from mobilenet_yolo_tpu.train import loop as j_loop
from mobilenet_yolo_tpu.train import state as j_state
from mobilenet_yolo_tpu_torch.data import augment
from mobilenet_yolo_tpu_torch.data import pipeline as t_pipeline
from mobilenet_yolo_tpu_torch.data import records as t_records
from mobilenet_yolo_tpu_torch.data.records import RecordWriter
from mobilenet_yolo_tpu_torch.data.synthetic import synthetic_batches
from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager
from mobilenet_yolo_tpu_torch.train.loop import Trainer, TrainerConfig, aug_seed

from _torch_parity import SMALL_YOLO_CONFIG, float64_pair, jax_train_state, perturb

CFG = dict(SMALL_YOLO_CONFIG, img_w=64, img_h=64, expand_scale=1.5)
CLASSES = ["background", "a", "b", "c"]
MEAN, STD = [0.5] * 3, [1.0] * 3


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """8 JPEG records of 64x72 (2 batches of 4), one box each of class 1-3."""
    rng = np.random.default_rng(0)
    d = str(tmp_path_factory.mktemp("loop") / "shard")
    with RecordWriter(d) as w:
        for i in range(8):
            img = rng.integers(0, 255, (64, 72, 3), np.uint8)
            cx, cy = rng.uniform(0.3, 0.7, 2)
            labels = np.asarray([[1 + i % 3, cx, cy, 0.4, 0.5]], np.float32)
            w.append_record(cv2.imencode(".jpg", img)[1].tobytes(), labels)
    return d


def _model(seed=0):
    return MBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35,
                    generator=torch.Generator().manual_seed(seed))


def _train_loader(pkg_pipeline, pkg_records, shard, geometry=False):
    ds = pkg_pipeline.DetectionDataset(pkg_records.RecordReader(shard), phase="train",
                                       expand_scale=1.5, apply_photometric=not geometry)
    return pkg_pipeline.Loader(ds, 4, [[64, 64]], MEAN, STD, mosaic_num=[1], max_gt=10,
                               prefetch=0, seed=3, device_geometry=geometry)


def _test_loader(pkg_pipeline, pkg_records, shard):
    ds = pkg_pipeline.DetectionDataset(pkg_records.RecordReader(shard), phase="test")
    return pkg_pipeline.Loader(ds, 4, [[64, 64]], MEAN, STD, shuffle=False, pad_final=False)


class Float64Batches:
    """A loader whose images come as float64 (the float64 models take them)."""

    def __init__(self, loader):
        self.loader = loader

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def set_skip(self, n):
        self.loader.set_skip(n)

    def __iter__(self):
        for batch in self.loader:
            yield dict(batch, images=batch["images"].astype(np.float64))


def _record(trainer) -> dict:
    """Wrap the trainer's step, epoch and eval to log what they did."""
    log = {"loss": [], "lr": [], "evals": []}
    step, epoch_fn, evaluate = trainer.train_step, trainer.train_epoch, trainer.evaluate

    def rec_step(*args, **kwargs):
        state, metrics = step(*args, **kwargs)
        log["loss"].append(float(metrics["loss"]))
        return state, metrics

    def rec_epoch(loader, epoch, start_batch=0):
        stats = epoch_fn(loader, epoch, start_batch)
        log["lr"].append((epoch, stats["lr"]))
        return stats

    def rec_eval(loader, batch_size=None):
        epoch, before = int(trainer.state.epoch), float(trainer.state.val_conf)
        mAP, aps = evaluate(loader, batch_size)
        log["evals"].append((epoch, before, mAP, float(trainer.state.val_conf)))
        return mAP, aps

    trainer.train_step, trainer.train_epoch, trainer.evaluate = rec_step, rec_epoch, rec_eval
    return log


def _log_rows(ckdir):
    with open(os.path.join(ckdir, "log.txt")) as f:
        header, *rows = f.read().strip().splitlines()
    return header, np.asarray([[float(v) for v in r.split("\t")] for r in rows])


def _variables64() -> dict:
    """Weights for the width-0.35 MBv2-YOLO (3 classes) drawn in numpy onto
    the JAX model's variable tree (its shapes from ``eval_shape``, so no
    init is compiled): He-normal kernels, zero conv biases, then
    ``perturb``'s BatchNorm statistics and spread ``out`` convs; float64."""
    jm = JaxMBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))
    rng = np.random.default_rng(5)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0.0, np.sqrt(2.0 / fan_in), leaf.shape).astype(np.float32)
        return np.zeros(leaf.shape, np.float32)

    drawn = perturb(jax.tree_util.tree_map_with_path(draw, dict(shapes)), seed=1)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), drawn)


@pytest.fixture(scope="module")
def jax_fit(shard, tmp_path_factory):
    """The JAX Trainer's 2-epoch plain fit in float64, run once. Its
    ``create_train_state`` is replaced by the state of ``_variables64``'s
    weights (the JAX init would be compiled, and its weights replaced), and
    ``TrainState.with_lr`` sets the rate in float64 (the same 1e-3 to
    4.7e-11 relative) to spare a second compile of the step."""
    variables = _variables64()
    ckdir = str(tmp_path_factory.mktemp("jax_fit") / "ck")
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        def state_of_variables(model, rng, img_size, learning_rate, weight_decay, ema):
            tx = j_state.make_optimizer(learning_rate, weight_decay)
            return jax_train_state(jax.tree_util.tree_map(jnp.asarray, variables), tx), tx

        def with_lr64(self, lr):
            # under x64 the JAX step returns the rate in float64, so the
            # package's float32 rate would compile the step twice an epoch
            self.opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float64)
            return self.replace(opt_state=self.opt_state)

        mp.setattr(j_loop, "create_train_state", state_of_variables)
        mp.setattr(j_state.TrainState, "with_lr", with_lr64)
        jm, _ = float64_pair(variables)
        tcfg = j_loop.TrainerConfig(epochs=2, learning_rate=1e-3, checkpoint_dir=ckdir,
                                    eval_every=2, tensorboard_dir=None, nms_top_k=64)
        trainer = j_loop.Trainer(jm, CFG, CLASSES, tcfg, verbose=False)
        log = _record(trainer)
        train = Float64Batches(_train_loader(j_pipeline, j_records, shard))
        test = Float64Batches(_test_loader(j_pipeline, j_records, shard))
        best = trainer.fit(lambda: train, lambda: test)
    mgr = j_checkpoints.CheckpointManager(ckdir)
    steps, best_step = sorted(mgr._mgr.all_steps()), mgr.best_step()
    mgr.close()
    return {"variables": variables, "log": log, "best": best, "ckdir": ckdir,
            "steps": steps, "best_step": best_step}


def test_fit_matches_jax(jax_fit, shard, tmp_path):
    """The port's 2-epoch fit against the JAX fit, float64 weights on both
    sides; both compute the loss in float32.

    Tolerances: the losses rtol 1e-4 (one step agrees to 1e-6; the
    differences grow with each AdamW step, to ~2e-6 by step 6, and a
    float32 IoU within rounding of an ignore threshold can flip an anchor's
    mask, after which the runs differ by ~0.5%: seen at step 7 of an
    8-step fit of this model); the LRs exactly; the evals at the same
    epochs, the ``val_conf`` before and after each within 1e-6 (JAX keeps
    it in float32), the mAP within 1e-4 (JAX decodes in float64, the port
    in float32); the ``log.txt`` rows within 1e-4, relative for the loss
    (6 printed decimals); the checkpoint steps and the best step equal."""
    _, model = float64_pair(jax_fit["variables"])
    ckdir = str(tmp_path / "ck")
    trainer = Trainer(model, CFG, CLASSES,
                      TrainerConfig(epochs=2, learning_rate=1e-3, checkpoint_dir=ckdir,
                                    eval_every=2, tensorboard_dir=None, nms_top_k=64),
                      verbose=False, device="cpu")
    log = _record(trainer)
    train = Float64Batches(_train_loader(t_pipeline, t_records, shard))
    test = Float64Batches(_test_loader(t_pipeline, t_records, shard))
    best = trainer.fit(lambda: train, lambda: test)

    want = jax_fit["log"]
    assert len(log["loss"]) == len(want["loss"]) == 4
    np.testing.assert_allclose(log["loss"], want["loss"], rtol=1e-4)
    assert log["lr"] == want["lr"] == [(0, 1e-3), (1, 1e-3)]
    assert [e[0] for e in log["evals"]] == [e[0] for e in want["evals"]] == [2]
    for got, ref in zip(log["evals"], want["evals"]):
        np.testing.assert_allclose(got[1], ref[1], atol=1e-6)
        np.testing.assert_allclose(got[2], ref[2], atol=1e-4)
        np.testing.assert_allclose(got[3], ref[3], atol=1e-6)
    np.testing.assert_allclose(best, jax_fit["best"], atol=1e-4)
    header, rows = _log_rows(ckdir)
    want_header, want_rows = _log_rows(jax_fit["ckdir"])
    assert header == want_header
    keep = [0, 1, 2, 4, 5]   # every column but Time
    np.testing.assert_allclose(rows[:, keep], want_rows[:, keep], atol=1e-4, rtol=1e-4)
    mgr = CheckpointManager(ckdir)
    assert mgr.all_steps() == jax_fit["steps"] == [1, 2]
    assert mgr.best_step() == jax_fit["best_step"] == 2


def test_predict_is_built_before_the_optimizer(tmp_path):
    """``make_predict_fn`` moves the model to channels_last; the optimizer
    holds the model's own ``Parameter`` objects, in that layout."""
    model = _model()
    trainer = Trainer(model, CFG, CLASSES,
                      TrainerConfig(epochs=1, checkpoint_dir=str(tmp_path / "ck")),
                      verbose=False, device="cpu")
    held = trainer.state.optimizer.param_groups[0]["params"]
    assert len(held) == len(list(model.parameters()))
    assert all(p is q for p, q in zip(held, model.parameters()))
    assert model.backbone.stem.conv.weight.is_contiguous(memory_format=torch.channels_last)




def test_aug_seed_depends_on_epoch_and_batch_alone():
    seeds = {aug_seed(e, i) for e in range(300) for i in range(600)}
    assert len(seeds) == 300 * 600
    assert all(0 <= s < 2 ** 31 for s in seeds)


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _synthetic(n, seed, bs=4):
    return [{"images": x, "gt": g, "n_gt": n_gt, "count": bs}
            for x, g, n_gt in synthetic_batches(n, bs, img_size=64, num_classes=3, seed=seed)]


def test_trainer_on_a_one_process_mesh_matches_no_mesh(tmp_path):
    """A 1x1 mesh in one process (no process group) trains an epoch and
    evaluates exactly as no mesh: every reduction is this process's own."""
    from mobilenet_yolo_tpu_torch.parallel import create_mesh
    runs = []
    for i, mesh in enumerate((None, create_mesh(1, 1))):
        tcfg = TrainerConfig(epochs=1, checkpoint_dir=str(tmp_path / str(i)), nms_top_k=32)
        trainer = Trainer(_model(), CFG, CLASSES, tcfg, mesh=mesh, verbose=False, device="cpu")
        stats = trainer.train_epoch(_synthetic(2, 5), 0)
        runs.append((stats["loss"], trainer.evaluate(_synthetic(1, 6))[0],
                     _params(trainer.model)))
    assert runs[0][:2] == runs[1][:2]
    _assert_same(runs[0][2], runs[1][2])


def test_eval_between_steps_leaves_the_next_step_unchanged(tmp_path):
    """Two trainers from one init, EMA on: X steps, evaluates, steps; Y
    steps twice. Their parameters, BatchNorm statistics, averages and
    optimizer state end equal bit for bit, and X's eval ran in eval mode
    on the averaged weights."""
    batches, evals = _synthetic(2, seed=1), _synthetic(1, seed=2)

    def make(name):
        tcfg = TrainerConfig(epochs=1, learning_rate=1e-3, checkpoint_dir=str(tmp_path / name),
                             tensorboard_dir=None, ema_decay=0.9)
        return Trainer(_model(), CFG, CLASSES, tcfg, verbose=False, device="cpu")

    x, y = make("x"), make("y")
    seen = {}
    predict = x.predict

    def watching_predict(images, val_conf):
        seen["training"] = x.model.training
        seen["weight"] = x.model.backbone.stem.conv.weight.detach().clone()
        return predict(images, val_conf)

    x.predict = watching_predict
    for t in (x, y):
        t.train_epoch(batches[:1], 0)
    ema_then = x.state.ema["backbone.stem.conv.weight"].clone()
    live_then = x.model.backbone.stem.conv.weight.detach().clone()
    assert not torch.equal(ema_then, live_then)
    x.evaluate(evals)
    assert seen["training"] is False
    assert torch.equal(seen["weight"], ema_then)
    assert torch.equal(x.model.backbone.stem.conv.weight, live_then)
    for t in (x, y):
        t.train_epoch(batches[1:], 0)
    _assert_same(_params(x.model), _params(y.model))
    _assert_same(x.state.ema, y.state.ema)
    x_opt = x.state.optimizer.state_dict()["state"]
    for i, st in y.state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(x_opt[i][k], v), (i, k)


def _loader_factory(seed_holder, batch_size=4):
    def loader():
        seed_holder["n"] += 1
        yield from _synthetic(3, seed_holder["n"], batch_size)
    return loader


def test_fit_runs_epochs_and_checkpoints(tmp_path):
    """``tests/test_trainer_fit.py:test_fit_runs_epochs_and_checkpoints``."""
    ckpt_dir = str(tmp_path / "ckpt")
    tcfg = TrainerConfig(epochs=2, learning_rate=1e-3, checkpoint_dir=ckpt_dir,
                         eval_every=2, tensorboard_dir=None)
    trainer = Trainer(_model(), CFG, CLASSES, tcfg, verbose=False, device="cpu")
    seeds = {"n": 0}
    best = trainer.fit(_loader_factory(seeds), _loader_factory(seeds))
    assert np.isfinite(best)
    assert int(trainer.state.epoch) == 2
    assert seeds["n"] >= 3  # 2 train epochs + >=1 eval pass
    with open(os.path.join(ckpt_dir, "log.txt")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 2
    trainer2 = Trainer(_model(seed=1), CFG, CLASSES, tcfg, verbose=False, device="cpu")
    assert trainer2.maybe_resume()
    assert int(trainer2.state.epoch) == 2
    _assert_same(_params(trainer2.model), _params(trainer.model))


def test_train_epoch_device_pixel_aug(tmp_path):
    """``test_trainer_fit.py:test_train_epoch_device_pixel_aug``: uint8
    batches with host-planned jitter programs drive the planned-order
    device jitter step."""
    cfg = dict(CFG, normalize={"mean": MEAN, "std": STD})
    tcfg = TrainerConfig(epochs=1, learning_rate=1e-3, checkpoint_dir=str(tmp_path / "ck"),
                         tensorboard_dir=None)
    trainer = Trainer(_model(), cfg, CLASSES, tcfg, verbose=False, device="cpu",
                      device_normalize=True, device_pixel_aug=True)
    rng = np.random.default_rng(3)

    def batches():
        for images, gt, n_gt in synthetic_batches(3, 4, img_size=64, num_classes=3, seed=5):
            raw = np.clip((images + 0.5) * 255.0, 0, 255).astype(np.uint8)
            plans = [augment.sample_photometric(rng) for _ in range(4)]
            yield {"images": raw, "gt": gt, "n_gt": n_gt,
                   "jitter_op": np.stack([p[0] for p in plans]),
                   "jitter_factor": np.stack([p[1] for p in plans])}

    assert np.isfinite(trainer.train_epoch(batches(), 0)["loss"])


def test_device_pixel_aug_batch_contract(tmp_path):
    """``test_trainer_fit.py:test_device_pixel_aug_batch_contract``."""
    tcfg = TrainerConfig(epochs=1, learning_rate=1e-3, checkpoint_dir=str(tmp_path / "ck"),
                         tensorboard_dir=None)
    seeds = {"n": 0}
    t1 = Trainer(_model(), CFG, CLASSES, tcfg, verbose=False, device="cpu",
                 device_normalize=True, device_pixel_aug=True)
    with pytest.raises(ValueError, match="jitter plans"):
        t1.train_epoch(_loader_factory(seeds)(), epoch=0)
    t2 = Trainer(_model(), CFG, CLASSES, tcfg, verbose=False, device="cpu")

    def plan_loader():
        for b in _loader_factory(seeds)():
            b["jitter_op"] = np.full((4, 5), -1, np.int32)
            b["jitter_factor"] = np.ones((4, 5), np.float32)
            yield b
    with pytest.raises(ValueError, match="device_pixel_aug=False"):
        t2.train_epoch(plan_loader(), epoch=0)


def _traces(tb):
    return glob.glob(str(tb / "profile" / "*.json"))


def test_profile_steps_writes_trace(tmp_path):
    """``test_trainer_fit.py:test_profile_steps_writes_trace``: a Chrome
    trace of the warm steps under ``<tensorboard_dir>/profile``, holding the
    step's ``myt:`` spans (the host's activity is recorded)."""
    tcfg = TrainerConfig(epochs=1, learning_rate=1e-3, checkpoint_dir=str(tmp_path / "ckpt"),
                         tensorboard_dir=str(tmp_path / "tb"), eval_every=2, profile_steps=1)
    trainer = Trainer(_model(), CFG, CLASSES, tcfg, verbose=False, device="cpu")
    seeds = {"n": 0}
    trainer.fit(_loader_factory(seeds), _loader_factory(seeds))
    traces = _traces(tmp_path / "tb")
    assert len(traces) == 1 and trainer._profiled
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"myt:loss", "myt:backward", "myt:optimizer", "myt:backbone", "myt:heads"} <= names


def test_profile_steps_longer_than_epoch(tmp_path):
    """``test_trainer_fit.py:test_profile_steps_longer_than_epoch``: the
    trace is closed at the epoch's end, and the next epoch starts none."""
    tcfg = TrainerConfig(epochs=2, learning_rate=1e-3, checkpoint_dir=str(tmp_path / "ckpt"),
                         tensorboard_dir=str(tmp_path / "tb"), eval_every=2, profile_steps=10)
    trainer = Trainer(_model(), CFG, CLASSES, tcfg, verbose=False, device="cpu")
    seeds = {"n": 0}
    trainer.fit(_loader_factory(seeds), _loader_factory(seeds))
    assert trainer._profiled and not trainer._trace_open
    assert len(_traces(tmp_path / "tb")) == 1


def test_profile_trace_records_the_host_beside_the_card(tmp_path, monkeypatch):
    """On a card the ``--profile-steps`` trace records the host's activity
    too, so the step's ``myt:`` spans reach it beside the card's work."""
    tcfg = TrainerConfig(epochs=1, learning_rate=1e-3, checkpoint_dir=str(tmp_path / "ckpt"),
                         tensorboard_dir=str(tmp_path / "tb"), profile_steps=1)
    trainer = Trainer(_model(), CFG, CLASSES, tcfg, verbose=False, device="cpu")
    trainer.device = torch.device("cuda")
    seen = []

    class _Profile:
        def __init__(self, activities):
            seen.extend(activities)

        def start(self):
            pass

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    trainer._start_trace()
    act = torch.profiler.ProfilerActivity
    assert sorted(seen, key=str) == sorted([act.CPU, act.CUDA], key=str)
