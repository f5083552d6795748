"""The port's training and eval front door on the CPU: ``cli/train.py``,
``cli/eval.py``, ``parallel/mesh.py`` in one process, the HPO driver
(``hpo/random_search.py``, ``train/hpo.py``) and the copied host utilities
(``utils/meters.py``, ``utils/logger.py``, ``utils/tb_writer.py``) against
the JAX package's.

The eval CLI cases mirror ``tests/test_cli_eval.py`` on its shards and
yamls; the mAP against ``Trainer.evaluate`` is held to 1e-9, as there.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu.train import hpo as j_hpo
from mobilenet_yolo_tpu.utils import logger as j_logger
from mobilenet_yolo_tpu.utils import meters as j_meters
from mobilenet_yolo_tpu.utils import tb_writer as j_tb_writer
from mobilenet_yolo_tpu_torch.cli import eval as cli_eval
from mobilenet_yolo_tpu_torch.cli import train as cli_train
from mobilenet_yolo_tpu_torch.config import load_config
from mobilenet_yolo_tpu_torch.data.pipeline import DetectionDataset, Loader
from mobilenet_yolo_tpu_torch.data.records import RecordReader
from mobilenet_yolo_tpu_torch.eval import evaluate_detection, make_predict_fn
from mobilenet_yolo_tpu_torch.hpo import random_search
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.parallel import mesh_from_spec, shard_batch, sync_processes
from mobilenet_yolo_tpu_torch.train import hpo
from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager
from mobilenet_yolo_tpu_torch.train.loop import TensorBoardWriter, Trainer, TrainerConfig
from mobilenet_yolo_tpu_torch.train.state import create_train_state
from mobilenet_yolo_tpu_torch.utils import logger, meters, tb_writer

from test_cli_eval import _write_configs, _write_shard  # its 3-class 64x64 shard and yamls

REPO = Path(__file__).resolve().parent.parent


def _jax_random_search():
    spec = importlib.util.spec_from_file_location("jax_random_search",
                                                  REPO / "hpo" / "random_search.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------- cli/train --


def test_cli_train_synthetic_runs_two_epochs(tmp_path, monkeypatch, capsys):
    """``--synthetic --device cpu``: two epochs of the full-width model, a
    checkpoint per epoch, ``log.txt``, TensorBoard events in the working
    directory; a second call resumes and trains nothing more."""
    monkeypatch.chdir(tmp_path)
    argv = ["--synthetic", "--device", "cpu", "--epochs", "2", "--steps-per-epoch", "2",
            "--batch-size", "4", "--img-size", "64", "-c", str(tmp_path / "ck")]
    best = cli_train.main(cli_train.get_params(argv))
    out = capsys.readouterr().out
    assert np.isfinite(best) and f"best mAP: {best:.4f}" in out
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [1, 2]
    with open(tmp_path / "ck" / "log.txt") as f:
        assert len(f.read().strip().splitlines()) == 1 + 2
    assert os.listdir(tmp_path / "tensorboard")
    cli_train.main(cli_train.get_params(argv))
    assert "resumed from epoch 2" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    ["--backbone", "mbv3"],
    ["--backbone", "mbv3_macc", "--slim-l1", "1e-2"],
    ["--slim-l1", "1e-2", "--slim-mode", "loss"],
])
def test_cli_train_takes_mbv3_and_slimming(tmp_path, monkeypatch, extra):
    """``--backbone mbv3*`` and ``--slim-l1`` / ``--slim-mode`` pass through:
    one synthetic step each, a finite loss in ``log.txt``, the checkpoint
    holds the chosen graph, and prox mode (the default) leaves some
    prunable gamma exactly 0 at this strength."""
    monkeypatch.chdir(tmp_path)
    argv = ["--synthetic", "--device", "cpu", "--epochs", "1", "--steps-per-epoch", "1",
            "--batch-size", "2", "--img-size", "64", "-c", str(tmp_path / "ck"), *extra]
    cli_train.main(cli_train.get_params(argv))
    rows = (tmp_path / "ck" / "log.txt").read_text().strip().splitlines()
    assert len(rows) == 2 and np.isfinite(float(rows[1].split("\t")[1]))
    model = CheckpointManager(str(tmp_path / "ck")).restore_latest_raw()["model"]
    backbone = extra[1] if extra[0] == "--backbone" else "mbv2"
    assert any(k.startswith("backbone.bneck") for k in model) == backbone.startswith("mbv3")
    if extra[-2:] == ["--slim-l1", "1e-2"]:
        gamma = model["backbone.bneck2_1.expand.bn.weight"]
        assert int((gamma == 0).sum()) > 0


@pytest.mark.parametrize("extra,error", [
    (["--coordinator", "localhost:1234"], None),
    (["--process-id", "0"], None),
    (["--mesh", "1x1"], None),
    (["--num-processes", "2"], "needs --coordinator and --process-id"),
    (["--mesh", "2"], "needs 2 devices, 1 visible"),
    (["--mesh", "1x2"], "needs 2 devices, 1 visible"),
])
def test_cli_train_process_flags_in_one_process(tmp_path, monkeypatch, extra, error):
    """The multi-process flags in one process, as the JAX CLI takes them: a
    coordinate alone or a 1x1 mesh trains in this process, a world above 1
    needs every coordinate, and a mesh over more ranks than there are
    raises ``ValueError`` (``tests/test_torch_multiprocess.py`` runs them
    over real process groups)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--synthetic", "--device", "cpu", "--epochs", "1", "--steps-per-epoch", "1",
            "--batch-size", "2", "--img-size", "64", "-c", str(tmp_path / "ck"), *extra]
    if error is None:
        assert np.isfinite(cli_train.main(cli_train.get_params(argv)))
    else:
        with pytest.raises(ValueError, match=error):
            cli_train.main(cli_train.get_params(argv))


def test_entry_points_raise_without_a_card_when_asked_for_cuda(tmp_path, monkeypatch):
    """``Trainer`` and both CLIs run on the card by default; with no card
    they raise rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    model = build_model({"yolo": {"num_classes": 3, "num_anchors": 3}}, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, {}, [], TrainerConfig(checkpoint_dir=str(tmp_path / "ck")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(cli_train.get_params(["--synthetic", "-c", str(tmp_path / "ck")]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_eval.main(["--random-weights"])


def test_cli_train_flags_match_jax():
    """Every flag of the JAX CLI, with its default; the port adds
    ``--device``."""
    from mobilenet_yolo_tpu.cli import train as j_cli_train
    want = vars(j_cli_train.get_params(["-y", "x.yaml"]))
    got = vars(cli_train.get_params(["-y", "x.yaml"]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_mesh_in_one_process():
    """One process without a process group: the one-device specs give no
    mesh, ``1x1`` a mesh without groups, a wider one raises; ``shard_batch``
    leaves this rank's batch where it is, the barrier is a no-op."""
    for spec in ("none", "off", "1", "auto", None):
        assert mesh_from_spec(spec, batch_size=8) is None
    mesh = mesh_from_spec("1x1", batch_size=8)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_group is None
    for spec in ("2", "1x2", "8"):
        with pytest.raises(ValueError, match="visible"):
            mesh_from_spec(spec)
    batch = {"images": torch.zeros(2, 4, 4, 3), "n_gt": torch.zeros(2)}
    assert shard_batch(mesh, batch) is batch
    with pytest.raises(ValueError, match="disagree on their rows"):
        shard_batch(mesh, {"images": torch.zeros(2, 1), "n_gt": torch.zeros(3)})
    assert sync_processes("pre_epoch") is None


# -------------------------------------------------------------- cli/eval --


def test_cli_eval_matches_trainer_evaluate(tmp_path, rng, capsys):
    """``tests/test_cli_eval.py:test_cli_eval_matches_trainer_evaluate``:
    the CLI's mAP and per-class APs equal ``Trainer.evaluate``'s to 1e-9 on
    the same seeded random weights (``--device cpu --mesh none``)."""
    shard = tmp_path / "shard"
    _write_shard(shard, rng)
    data_yaml = _write_configs(tmp_path, shard)
    cfg = load_config(data_yaml)
    model = build_model(cfg.model, device="cpu", generator=torch.Generator().manual_seed(0))
    tcfg = TrainerConfig(checkpoint_dir=str(tmp_path / "ck"), tensorboard_dir=None,
                         nms_top_k=int(cfg.model["nms_top_k"]))
    trainer = Trainer(model, cfg.model, cfg.classes, tcfg, verbose=False, device="cpu")
    trainer.state.val_conf = 0.05
    norm = cfg.model["normalize"]
    loader = Loader(DetectionDataset(RecordReader(str(shard)), phase="test"), 4, [[64, 64]],
                    norm["mean"], norm["std"], shuffle=False, pad_final=False)
    want_mAP, want_aps = trainer.evaluate(loader)

    got_mAP = cli_eval.main(["-y", data_yaml, "--random-weights", "--val-conf", "0.05",
                             "--batch-size", "4", "--mesh", "none", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert got_mAP == pytest.approx(want_mAP, abs=1e-9)
    for k, v in want_aps.items():
        assert out["APs"][k] == pytest.approx(v, abs=1e-9)
    assert "seg_mIoU" not in out


def test_cli_eval_reports_seg_miou(tmp_path, rng, capsys):
    """``tests/test_cli_eval.py:test_cli_eval_reports_seg_miou``."""
    shard = tmp_path / "shard"
    _write_shard(shard, rng, seg=True)
    data_yaml = _write_configs(tmp_path, shard, seg=True)
    mAP = cli_eval.main(["-y", data_yaml, "--random-weights", "--val-conf", "0.05",
                         "--batch-size", "4", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert np.isfinite(mAP)
    assert "seg_mIoU" in out and 0.0 <= out["seg_mIoU"] <= 1.0


def test_cli_eval_coco_ap_flag(tmp_path, rng, capsys):
    """``tests/test_cli_eval.py:test_cli_eval_coco_ap_flag``."""
    shard = tmp_path / "shard"
    _write_shard(shard, rng)
    data_yaml = _write_configs(tmp_path, shard)
    cli_eval.main(["-y", data_yaml, "--random-weights", "--val-conf", "0.05",
                   "--batch-size", "4", "--mesh", "none", "--coco-ap", "--device", "cpu"])
    coco = json.loads(capsys.readouterr().out)["coco"]
    assert set(coco) == {"AP", "AP50", "AP75", "APsmall", "APmedium", "APlarge", "per_class"}
    assert coco["AP50"] + 1e-9 >= coco["AP"] >= coco["AP75"] - 1e-9
    assert 0.0 <= coco["AP"] <= 1.0
    for k in ("APsmall", "APmedium", "APlarge"):
        assert coco[k] == -1.0 or 0.0 <= coco[k] <= 1.0


def test_cli_eval_restores_val_conf_and_ema_from_a_checkpoint(tmp_path, rng, capsys):
    """A checkpoint directory gives the run's adapted ``val_conf`` (unless
    ``--val-conf``) and its averaged weights: the mAP equals
    ``evaluate_detection`` on those weights at that gate, to 1e-9."""
    shard = tmp_path / "shard"
    _write_shard(shard, rng)
    data_yaml = _write_configs(tmp_path, shard)
    cfg = load_config(data_yaml)
    model = build_model(cfg.model, device="cpu", generator=torch.Generator().manual_seed(4))
    state = create_train_state(model, ema=True, val_conf=0.07)
    state.ema = {k: v * 0.9 for k, v in state.ema.items()}
    CheckpointManager(str(tmp_path / "ck")).save(3, state)

    got = cli_eval.main(["-y", data_yaml, "-c", str(tmp_path / "ck"), "--batch-size", "4",
                         "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["val_conf"] == 0.07
    served = build_model(cfg.model, device="cpu")
    served.load_state_dict({**model.state_dict(), **state.ema})
    norm = cfg.model["normalize"]
    loader = Loader(DetectionDataset(RecordReader(str(shard)), phase="test"), 4, [[64, 64]],
                    norm["mean"], norm["std"], shuffle=False, pad_final=False)
    want = evaluate_detection(make_predict_fn(served, cfg.model, top_k=cfg.model["nms_top_k"]),
                              loader, cfg.classes, 0.07, batch_size=4, device="cpu")
    assert got == pytest.approx(want["mAP"], abs=1e-9)
    cli_eval.main(["-y", data_yaml, "-c", str(tmp_path / "ck"), "--batch-size", "4",
                   "--device", "cpu", "--val-conf", "0.2"])
    assert json.loads(capsys.readouterr().out)["val_conf"] == 0.2


# ------------------------------------------------------------------- HPO --


def test_search_space_is_the_repositorys():
    ours = Path(random_search.__file__).parent / "search_space.json"
    assert ours.read_bytes() == (REPO / "hpo" / "search_space.json").read_bytes()


def test_random_search_sampler_matches_jax():
    """One seed, the same draws: ``sample_params`` equals the JAX driver's
    draw for draw, and every key is a flag of the port's train CLI."""
    j_rs = _jax_random_search()
    with open(REPO / "hpo" / "search_space.json") as f:
        space = json.load(f)
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(20):
        assert random_search.sample_params(space, a) == j_rs.sample_params(space, b)
    args = cli_train.get_params(["-y", "x.yaml"])
    assert all(hasattr(args, k) for k in space)


def test_random_search_drives_the_port_cli(tmp_path, monkeypatch):
    """The tuner-override seam: each trial's sampled params reach
    ``cli.train.main`` as attributes, with its ``--device``; the trial
    table is written."""
    seen = []

    def fake_main(args, report=None):
        seen.append(args)
        report.intermediate(0.1)
        report.final(0.2)
        return 0.2

    monkeypatch.setattr(cli_train, "main", fake_main)
    out = tmp_path / "trials.json"
    rows = random_search.main(["-y", "d.yaml", "--trials", "2", "--epochs", "1", "--device",
                               "cpu", "--workdir", str(tmp_path / "runs"), "--out", str(out)])
    with open(REPO / "hpo" / "search_space.json") as f:
        keys = set(json.load(f))
    assert len(seen) == 2 and all(a.device == "cpu" and a.epochs == 1 for a in seen)
    for args, row in zip(seen, rows):
        assert {k: getattr(args, k) for k in keys} == row["params"]
        assert row["intermediates"] == [0.1] and row["final_report"] == 0.2
    assert json.loads(out.read_text()) == rows


def test_random_search_refuses_stale_workdir(tmp_path):
    """``tests/test_hpo.py:test_random_search_refuses_stale_workdir``."""
    stale = tmp_path / "trial_0"
    stale.mkdir(parents=True)
    (stale / "leftover").write_text("x")
    with pytest.raises(FileExistsError, match="previous run"):
        random_search.main(["-y", "unused.yaml", "--trials", "1", "--workdir", str(tmp_path)])


def test_hpo_seam_matches_jax():
    assert hpo.get_tuner_overrides() == j_hpo.get_tuner_overrides() == {}
    hook = hpo.make_report_hook()
    assert isinstance(hook, hpo.NoOpReport)
    hook.intermediate(0.5)
    hook.final(0.7)


# ------------------------------------------------------------- utilities --


def test_meters_match_jax():
    updates = [({"loss": 1.0, "iou": 0.25}, 4), ({"loss": 3.0}, 2), ({"loss": 0.5, "iou": 1.0}, 3)]
    ours, theirs = meters.MeterDict(), j_meters.MeterDict()
    for values, n in updates:
        ours.update(values, n)
        theirs.update(values, n)
    assert ours.averages() == theirs.averages()
    for k in ("loss", "iou"):
        assert vars(ours[k]) == vars(theirs[k])
    m, jm = meters.AverageMeter(), j_meters.AverageMeter()
    for v, n in ((1.0, 1), (3.0, 3)):
        m.update(v, n)
        jm.update(v, n)
    assert vars(m) == vars(jm)
    images = [np.random.default_rng(i).random((4, 4, 3)) for i in range(3)]
    for a, b in zip(meters.get_mean_and_std(images), j_meters.get_mean_and_std(images)):
        np.testing.assert_array_equal(a, b)


def test_logger_matches_jax(tmp_path):
    """The same appends give byte-identical ``log.txt`` files, and a resume
    parses them to the same columns."""
    rows = [[1, 0.5, 0.0, 12.3, 0.25, 7e-4], [2, 0.25, 0.125, 11.0, 0.5, 3.5e-4]]
    paths = {}
    for name, module in (("port", logger), ("jax", j_logger)):
        paths[name] = str(tmp_path / f"{name}.txt")
        lg = module.Logger(paths[name], title="training-process")
        lg.set_names(["Epoch", "Loss", "Precision", "Time", "IOU", "LearningRate"])
        for r in rows:
            lg.append(r)
        lg.close()
    assert Path(paths["port"]).read_bytes() == Path(paths["jax"]).read_bytes()
    ours = logger.Logger(paths["port"], resume=True)
    theirs = j_logger.Logger(paths["jax"], resume=True)
    assert ours.names == theirs.names and ours.numbers == theirs.numbers
    ours.close()
    theirs.close()


def test_tb_writer_matches_jax_byte_for_byte(tmp_path):
    """With the clock fixed, the event files hold the same bytes; the
    trainer's writer emits the version record and one scalar."""
    files = {}
    for name, module in (("port", tb_writer), ("jax", j_tb_writer)):
        clock = iter([1000.0, 1000.0, 1001.5, 1002.0, 1003.25]).__next__
        with module.EventFileWriter(str(tmp_path / name), clock=clock) as w:
            w.scalar("Loss/train", 0.25, 1)
            w.scalar("Accuracy/test", 0.75, 2)
            w.scalar("iou/train", 1e-3, 3)
            files[name] = w.path
    assert Path(files["port"]).read_bytes() == Path(files["jax"]).read_bytes()
    assert tb_writer.crc32c(b"123456789") == 0xE3069283
    tbw = TensorBoardWriter(str(tmp_path / "tb"))
    tbw.scalar("Loss/train", 1.5, 0)
    tbw.close()
    assert os.path.getsize(tbw._writer.path) > 0
