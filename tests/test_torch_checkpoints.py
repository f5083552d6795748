"""The port's checkpoints (``mobilenet_yolo_tpu_torch/train/checkpoints.py``)
on the CPU.

* Retention against the JAX manager (Orbax): one sequence of saves and
  metrics, each step kept by both, the best step the same; where Orbax
  deletes the newest step (its mAP not among the best), the port keeps it.
* Save and restore: every field round-trips exactly; a killed save or a
  temporary directory left over leaves the last whole step restorable;
  the strict restore refuses an EMA mismatch that the flexible one bridges.
* The mirrors of ``tests/test_checkpoints.py:test_midepoch_resume_bit_exact``
  (plain mode, and geometry mode with the plain augmentation) and of
  ``tests/test_ema.py``'s trainer tests, bit for bit.
* ``cli/infer.py`` serves a checkpoint directory, the averaged weights
  where the run kept them.
"""

import os

import jax.numpy as jnp
import pytest
import torch

from mobilenet_yolo_tpu.train import checkpoints as j_checkpoints
from mobilenet_yolo_tpu_torch.cli import infer
from mobilenet_yolo_tpu_torch.config import load_config
from mobilenet_yolo_tpu_torch.data import pipeline as t_pipeline
from mobilenet_yolo_tpu_torch.data import records as t_records
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager, served_state_dict
from mobilenet_yolo_tpu_torch.train.loop import Trainer, TrainerConfig
from mobilenet_yolo_tpu_torch.train.state import create_train_state

from test_cli_infer import _write_configs, _write_images  # its 3-class 96x96 yamls
from test_torch_loop import (CFG, CLASSES, MEAN, STD, _assert_same,  # noqa: F401
                             _loader_factory, _model, _params, _train_loader, shard)

# (step, mAP or None): metric-less steps between evaluated ones, equal mAPs,
# a best that stays, and newest steps whose mAP is not among the best
SAVES = [(1, None), (2, 0.10), (3, None), (4, 0.30), (5, 0.20), (6, 0.20), (7, None),
         (8, 0.05), (9, 0.25), (10, 0.01)]


def _tiny_state(seed=0, ema=False):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    state = create_train_state(model, ema=ema)
    loss = model(torch.randn(8, 3)).square().mean()
    loss.backward()
    state.optimizer.step()
    return state


def test_retention_matches_the_jax_manager(tmp_path):
    """After each save, the port keeps what Orbax keeps, plus the newest
    step where Orbax deleted it; the best step is the same throughout."""
    jmgr = j_checkpoints.CheckpointManager(str(tmp_path / "jax"))
    mgr = CheckpointManager(str(tmp_path / "port"))
    state = _tiny_state()
    newest_deleted = 0
    for step, mAP in SAVES:
        jmgr.save(step, {"w": jnp.zeros(2)}, mAP=mAP, wait=True)
        mgr.save(step, state, mAP=mAP)
        kept = sorted(jmgr._mgr.all_steps())
        newest_deleted += step not in kept
        assert mgr.all_steps() == sorted(set(kept) | {step}), step
        assert mgr.best_step() == jmgr.best_step(), step
        assert mgr.latest_step() == step
    jmgr.close()
    assert mgr.all_steps() == [1, 3, 4, 6, 7, 9, 10]
    assert newest_deleted == 2    # steps 8 and 10: Orbax's newest went
    with pytest.raises(ValueError, match="already exists"):
        mgr.save(10, state)


def test_save_restore_roundtrip(tmp_path):
    """``tests/test_checkpoints.py:test_save_restore_roundtrip``, and every
    tensor of the model, optimizer and average restored exactly."""
    state = _tiny_state(ema=True)
    state.epoch, state.best_acc, state.val_conf, state.batch_idx = 7, 0.5, 0.08, 3
    state.ema = {k: v + 1.0 for k, v in state.ema.items()}
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(7, state, mAP=0.5, wait=True)
    template = _tiny_state(seed=1, ema=True)
    restored = mgr.restore_latest(template)
    assert restored is template
    assert (restored.epoch, restored.best_acc, restored.val_conf, restored.batch_idx) == \
        (7, 0.5, 0.08, 3)
    _assert_same(restored.model.state_dict(), state.model.state_dict())
    _assert_same(restored.ema, state.ema)
    want, got = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    raw = mgr.restore_latest_raw()
    assert all(v.device.type == "cpu" for v in raw["model"].values())
    assert served_state_dict(raw)["0.weight"].equal(state.ema["0.weight"])
    assert served_state_dict(raw)["1.running_mean"].equal(state.model[1].running_mean)


def test_restore_none_when_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.restore_latest(_tiny_state()) is None
    assert mgr.restore_latest_raw() is None
    assert mgr.latest_step() is None and mgr.best_step() is None


def test_strict_restore_refuses_an_ema_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, _tiny_state(ema=False))
    with pytest.raises(ValueError, match="restore_latest_flexible"):
        mgr.restore(1, _tiny_state(ema=True))
    flexible = mgr.restore_latest_flexible(_tiny_state(seed=1, ema=True))
    _assert_same(flexible.ema, dict(flexible.model.named_parameters()))


def test_a_killed_save_leaves_the_last_whole_step(tmp_path, monkeypatch):
    """A save that dies inside ``torch.save`` leaves only its temporary
    directory; readers list the last whole step, restore it, and the next
    manager removes the leftover."""
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d)
    state = _tiny_state()
    state.epoch = 3
    mgr.save(3, state)

    def dies(obj, path):
        with open(path, "wb") as f:
            f.write(b"\x80partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", dies)
    state.epoch = 4
    with pytest.raises(KeyboardInterrupt):
        mgr.save(4, state)
    monkeypatch.undo()
    leftovers = [n for n in os.listdir(d) if n.startswith(".tmp-")]
    assert leftovers and mgr.all_steps() == [3]
    reader = CheckpointManager(d)
    assert reader.latest_step() == 3 and reader.restore_latest(_tiny_state(seed=2)).epoch == 3
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]


@pytest.mark.parametrize("geometry", [False, True], ids=["plain", "geometry"])
def test_midepoch_resume_bit_exact(shard, tmp_path, geometry):
    """Kill/resume mid-epoch reproduces the uninterrupted run bit for bit
    (``tests/test_checkpoints.py:test_midepoch_resume_bit_exact``): run B
    checkpoints after every batch; run C restores B's snapshot after batch
    1 of epoch 1 and finishes; A, B and C end with equal parameters and
    BatchNorm statistics, and A and C with equal optimizer state. Two
    epochs of 2 batches. Geometry mode runs the plain augmentation (the
    step's mode for CPU tensors), its noise keyed by ``aug_seed``."""
    cfg = dict(CFG, normalize={"mean": MEAN, "std": STD})

    def make_loader():
        return _train_loader(t_pipeline, t_records, shard, geometry=geometry)

    def make_trainer(ckdir, every=0):
        tcfg = TrainerConfig(epochs=2, learning_rate=1e-3, checkpoint_dir=str(tmp_path / ckdir),
                             tensorboard_dir=None, checkpoint_every_batches=every,
                             eval_every=4)
        return Trainer(_model(), cfg, CLASSES, tcfg, verbose=False, device="cpu",
                       device_geometry=geometry)

    def run(trainer):
        loader = make_loader()
        trainer.fit(lambda: loader, make_loader)
        return _params(trainer.model), trainer.state.optimizer.state_dict()

    a, a_opt = run(make_trainer("a"))
    b, _ = run(make_trainer("b", every=1))
    _assert_same(a, b)
    assert 1_000_001 in CheckpointManager(str(tmp_path / "b")).all_steps()

    c_trainer = make_trainer("c", every=1)
    restored = CheckpointManager(str(tmp_path / "b")).restore(1_000_001, c_trainer.state)
    assert (restored.epoch, restored.batch_idx) == (1, 1)
    c_trainer.state = restored
    c, c_opt = run(c_trainer)
    _assert_same(a, c)
    assert c_opt["state"].keys() == a_opt["state"].keys()
    for i in a_opt["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a_opt["state"][i][k], c_opt["state"][i][k]), (i, k)




def test_trainer_fit_with_ema_and_raw_restore(tmp_path):
    """``tests/test_ema.py:test_trainer_fit_with_ema_and_raw_restore``."""
    tcfg = TrainerConfig(epochs=2, learning_rate=2e-3, checkpoint_dir=str(tmp_path / "ck"),
                         tensorboard_dir=None, eval_every=2, ema_decay=0.9)
    trainer = Trainer(_model(), CFG, CLASSES, tcfg, verbose=False, device="cpu")
    seeds = {"n": 0}
    trainer.fit(_loader_factory(seeds), _loader_factory(seeds))
    name = "backbone.stem.conv.weight"
    live = trainer.model.state_dict()[name]
    assert not torch.allclose(live, trainer.state.ema[name])
    raw = CheckpointManager(tcfg.checkpoint_dir).restore_latest_raw()
    assert raw is not None and raw["ema"] is not None
    assert torch.equal(raw["ema"][name], trainer.state.ema[name])
    assert torch.equal(raw["model"][name], live)

    tcfg2 = TrainerConfig(epochs=1, learning_rate=2e-3, checkpoint_dir=str(tmp_path / "ck2"),
                          tensorboard_dir=None, eval_every=2)
    t2 = Trainer(_model(), CFG, CLASSES, tcfg2, verbose=False, device="cpu")
    t2.fit(_loader_factory(seeds), _loader_factory(seeds))
    raw2 = CheckpointManager(tcfg2.checkpoint_dir).restore_latest_raw()
    assert raw2 is not None and raw2["ema"] is None and raw2["model"]


def test_resume_across_ema_toggle(tmp_path):
    """``tests/test_ema.py:test_resume_across_ema_toggle``: a run saved WITH
    EMA resumes into a non-EMA trainer (average dropped); a non-EMA
    checkpoint resumes into an EMA trainer, the average seeded from the
    restored parameters."""
    seeds = {"n": 0}
    name = "backbone.stem.conv.weight"

    def trainer(ckdir, ema, seed=0):
        tcfg = TrainerConfig(epochs=1, learning_rate=2e-3, checkpoint_dir=str(tmp_path / ckdir),
                             tensorboard_dir=None, ema_decay=ema)
        return Trainer(_model(seed), CFG, CLASSES, tcfg, verbose=False, device="cpu")

    t = trainer("ck_ema", 0.9)
    t.fit(_loader_factory(seeds), _loader_factory(seeds))
    t2 = trainer("ck_ema", 0.0, seed=1)
    assert t2.maybe_resume()
    assert t2.state.ema is None and int(t2.state.epoch) == 1
    assert torch.equal(t2.model.state_dict()[name], t.model.state_dict()[name])

    t3 = trainer("ck_plain", 0.0)
    t3.fit(_loader_factory(seeds), _loader_factory(seeds))
    t4 = trainer("ck_plain", 0.9, seed=1)
    assert t4.maybe_resume()
    assert torch.equal(t4.state.ema[name], t3.model.state_dict()[name])


def test_infer_serves_the_ema_weights_of_a_checkpoint_directory(tmp_path, rng, monkeypatch):
    """``cli/infer.py -c <dir>``: the latest step's averaged weights with the
    live BatchNorm statistics when the run kept an average, the live
    weights when it did not."""
    data_yaml = _write_configs(tmp_path)
    _write_images(str(tmp_path / "imgs"), 1, rng)
    cfg = load_config(data_yaml)
    served = {}

    def recording_make_predict_fn(model, config, **kwargs):
        served["weights"] = {k: v.clone() for k, v in model.state_dict().items()}
        return make_predict_fn(model, config, **kwargs)

    make_predict_fn = infer.make_predict_fn
    monkeypatch.setattr(infer, "make_predict_fn", recording_make_predict_fn)
    for ema in (True, False):
        ckdir = tmp_path / f"ck_{ema}"
        model = build_model(cfg.model, device="cpu", generator=torch.Generator().manual_seed(3))
        state = create_train_state(model, ema=ema)
        if ema:
            state.ema = {k: v * 0.5 for k, v in state.ema.items()}
        CheckpointManager(str(ckdir)).save(1, state)
        out = infer.main(infer.get_args(["-y", data_yaml, "--img-size", "96", "--device", "cpu",
                                         "-c", str(ckdir), "-i",
                                         str(tmp_path / "imgs" / "im0.jpg"),
                                         "--out-dir", str(tmp_path / f"save_{ema}")]))
        assert os.path.isfile(out)
        want = dict(model.state_dict())
        if ema:
            want.update(state.ema)
        _assert_same(served["weights"], want)
