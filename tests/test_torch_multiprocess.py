"""The port's parallelism in real multi-process jobs on localhost CPUs (gloo),
held against the JAX package's mesh and against one process.

The JAX side runs here, on 2 of the 8 virtual CPU devices
(``tests/conftest.py``); the port's ranks are separate processes
(``tests/_torch_mp_worker.py``, which imports no JAX), all started once for
the module and run while the JAX steps compile:

* ``steps``, 2 ranks, the width-0.35 MBv2-YOLO with the JAX init's
  (perturbed) weights in float64: the data-parallel plain and geometry
  steps (mesh 2x1) against JAX's 2-device mesh steps, the same plain step
  with remat, the tensor-parallel step (mesh 1x2, ``min_channels`` 128)
  against JAX's and against the data-parallel step, the same with
  ``slim_mode: loss`` (the whole model's L1 penalty on every rank, its
  gradient once on each rank's slice of a split gamma), the sharded predict
  under both meshes and ``evaluate_detection`` on the 2x1 mesh against one
  process, and an epoch of the ``Loader``, which finds its rank in the
  group, against the JAX loader's slice for that rank;
* ``trainer``, 4 ranks, a 2x2 ``Trainer`` (float64) against a one-process
  one;
* the train CLI as two processes (``--coordinator/--num-processes/
  --process-id``): train, lockstep eval and a checkpoint that loads in one
  process.

Tolerances: the steps as ``test_torch_train.py`` holds the one-process
step to JAX (loss rtol 1e-6, a float32 loss on both sides; params and EMA
atol 1e-5; BatchNorm statistics rtol 1e-9 in float64); remat against no
remat atol 1e-12; predict rtol 1e-4 / atol 1e-5 with ``keep`` equal (JAX's
``test_mesh_sharded_predict_matches_single_device``); mAP 1e-9. The
Trainer runs in float64 too (loss and IoU rtol 1e-6, mAP 1e-9, val_conf
equal): in float32 the first AdamW step's sign flips on near-zero
gradients move the second step's IoU by ~1%. Every rank's loss and mAP are
equal bit for bit.
"""

import json
import os
import socket
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu.data import pipeline as j_pipeline
from mobilenet_yolo_tpu.data import records as j_records
from mobilenet_yolo_tpu.parallel import mesh as j_mesh
from mobilenet_yolo_tpu.parallel.sharding import _leaf_sharding, shard_over_model_axis
from mobilenet_yolo_tpu.train import state as j_state
from mobilenet_yolo_tpu.train import step as j_step
from mobilenet_yolo_tpu.train.step import GEOMETRY_BATCH_KEYS
from mobilenet_yolo_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from mobilenet_yolo_tpu_torch.data.records import RecordWriter
from mobilenet_yolo_tpu_torch.data.synthetic import synthetic_batches
from mobilenet_yolo_tpu_torch.eval.detector import make_predict_fn
from mobilenet_yolo_tpu_torch.eval.evaluator import evaluate_detection
from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
from mobilenet_yolo_tpu_torch.prune import _gamma_key, prunable_gammas
from mobilenet_yolo_tpu_torch.tools_io import save_params_npz
from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager
from mobilenet_yolo_tpu_torch.train.loop import Trainer, TrainerConfig

from _torch_parity import (REPO, SMALL_YOLO_CONFIG, float64_pair, geometry_batch,
                           jax_train_state, padded_gt, state_dict_of, width035_variables64)

WORKER = os.path.join(REPO, "tests", "_torch_mp_worker.py")
TIMEOUT = 300
CLASSES = ["bg", "a", "b", "c"]
# the slim-loss steps' L1 strength: large enough that the penalty's
# gradient (slim_l1 / gamma's sign) competes with the data's on the first
# AdamW step, so a gradient counted twice flips gammas' updates
SLIM_CONFIG = dict(SMALL_YOLO_CONFIG, slim_l1=1e-2, slim_mode="loss")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


class _Job:
    """Processes started together; ``wait`` returns their outputs."""

    def __init__(self, cmds: list, cwd: str):
        self.procs = [subprocess.Popen(cmd, cwd=cwd, env=_env(), stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True) for cmd in cmds]
        self.outs = None

    def wait(self) -> list[str]:
        if self.outs is None:
            self.outs = [p.communicate(timeout=TIMEOUT)[0] for p in self.procs]
            for p, out in zip(self.procs, self.outs):
                assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
        return self.outs


def _worker_job(job: str, world: int, d) -> _Job:
    port = _free_port()
    return _Job([[sys.executable, WORKER, "--job", job, "--rank", str(r), "--world", str(world),
                  "--port", str(port), "--dir", str(d)] for r in range(world)], str(d))


def _port_model(variables64) -> MBv2YOLO:
    return load_flax_variables(
        MBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35, dtype=torch.float64),
        variables64)


def _eval_batches(variables64):
    """7 images whose GT is every other detection of the one-process predict,
    shifted a little: an mAP between 0 and 1."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.5, 0.5, (7, 64, 64, 3))
    dets, keep = make_predict_fn(_port_model(variables64), SMALL_YOLO_CONFIG, top_k=32)(
        torch.from_numpy(x), torch.tensor(0.01))
    gt, n_gt = np.zeros((7, 4, 5)), np.zeros(7, np.int32)
    for b in range(7):
        d = dets[b][keep[b]].numpy()[::2][:4]
        n_gt[b] = len(d)
        gt[b, :len(d), 0] = d[:, 6] + 1
        gt[b, :len(d), 1:3] = (d[:, 0:2] + d[:, 2:4]) / 2 + rng.normal(0, 0.01, (len(d), 2))
        gt[b, :len(d), 3:5] = d[:, 2:4] - d[:, 0:2]
    return x, gt, n_gt


@pytest.fixture(scope="module")
def variables64():
    return width035_variables64()


@pytest.fixture(scope="module")
def inputs(variables64):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, 32, 32, 3))
    gt, n_gt = padded_gt(rng, [2, 0, 3, 6], 6)
    geo = geometry_batch(np.random.default_rng(1), 4, 32)
    # as test_geometry_step_matches_jax: no contrast, hue or mean fill
    geo["jitter_op"][np.isin(geo["jitter_op"], (1, 3))] = -1
    geo["fill_from_mean"][:] = False
    eval_x, eval_gt, eval_n_gt = _eval_batches(variables64)
    return {"x": x, "gt": gt, "n_gt": n_gt, "geo": geo,
            "predict_x": np.random.default_rng(11).uniform(-0.5, 0.5, (8, 64, 64, 3)),
            "eval_x": eval_x, "eval_gt": eval_gt, "eval_n_gt": eval_n_gt}


@pytest.fixture(scope="module")
def jax_slim_tp_step(variables64, inputs):
    """JAX's slim-loss TP step, compiled and run in a thread beside the
    other tests' JAX steps and the workers (a future of ``_jax_step``)."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_step, variables64, inputs,
                          j_mesh.create_mesh(n_data=1, n_model=2), tp=True, config=SLIM_CONFIG)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, variables64, inputs, jax_slim_tp_step):
    """Every multi-process job, started at once (with JAX's slim-loss TP
    step)."""
    steps_dir = tmp_path_factory.mktemp("steps")
    save_params_npz(str(steps_dir / "weights.npz"), variables64["params"],
                    variables64["batch_stats"])
    with open(steps_dir / "config.json", "w") as f:
        json.dump(SMALL_YOLO_CONFIG, f)
    with open(steps_dir / "slim_config.json", "w") as f:
        json.dump(SLIM_CONFIG, f)
    np.savez(steps_dir / "batches.npz", x=inputs["x"], gt=inputs["gt"], n_gt=inputs["n_gt"],
             predict_x=inputs["predict_x"], eval_x=inputs["eval_x"],
             eval_gt=inputs["eval_gt"], eval_n_gt=inputs["eval_n_gt"],
             **{f"geo_{k}": v for k, v in inputs["geo"].items()})

    rng = np.random.default_rng(0)
    with RecordWriter(str(steps_dir / "shard")) as w:
        for i in range(8):
            labels = np.asarray([[1 + i % 3, *rng.uniform(0.3, 0.7, 2), 0.4, 0.5]], np.float32)
            w.append_record(cv2.imencode(".jpg", rng.integers(0, 255, (64, 72, 3), np.uint8))[1]
                            .tobytes(), labels)

    trainer_dir = tmp_path_factory.mktemp("trainer")
    with open(trainer_dir / "config.json", "w") as f:
        json.dump(dict(SMALL_YOLO_CONFIG, img_w=64, img_h=64), f)
    x, gt, n_gt = zip(*synthetic_batches(2, 8, img_size=64, num_classes=3, seed=3))
    np.savez(trainer_dir / "batches.npz", x=np.concatenate(x).astype(np.float64),
             gt=np.concatenate(gt), n_gt=np.concatenate(n_gt))

    cli_dir = tmp_path_factory.mktemp("cli")
    port = _free_port()
    cli = _Job([[sys.executable, "-m", "mobilenet_yolo_tpu_torch.cli.train", "--synthetic",
                 "--device", "cpu", "--epochs", "2", "--steps-per-epoch", "2",
                 "--batch-size", "4", "--img-size", "64", "--mesh", "2",
                 "--learning_rate", "1e-3", "--schedule", "999", "-c", str(cli_dir / "ck"),
                 "--coordinator", f"localhost:{port}", "--num-processes", "2",
                 "--process-id", str(r)] for r in range(2)], str(cli_dir))
    started = {"steps": (_worker_job("steps", 2, steps_dir), steps_dir),
               "trainer": (_worker_job("trainer", 4, trainer_dir), trainer_dir),
               "cli": (cli, cli_dir)}
    yield started
    for job, _ in started.values():
        for p in job.procs:
            if p.poll() is None:
                p.kill()


def _ranks(jobs, name: str, world: int):
    job, d = jobs[name]
    job.wait()
    infos = [json.load(open(d / f"rank{r}.json")) for r in range(world)]
    arrays = [dict(np.load(d / f"rank{r}.npz")) for r in range(world)] \
        if (d / "rank0.npz").exists() else None
    return infos, arrays, d


def _prefixed(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def _jax_step(variables64, inputs, mesh, geometry=False, tp=False, config=SMALL_YOLO_CONFIG):
    """JAX's mesh step on the same weights and batch, float64, AdamW (and the
    EMA of the plain step)."""
    with jax.enable_x64(True):
        jm, _ = float64_pair(variables64)
        tx = j_state.make_optimizer(7e-4, 4e-4)
        state = jax_train_state(variables64, tx)
        if geometry:
            step = j_step.make_geometry_train_step(jm, config, tx, mesh=mesh,
                                                   fused_aug=False)
            geo = inputs["geo"]
            args = j_mesh.shard_batch(mesh, tuple(jnp.asarray(geo[k]) for k in
                                                  GEOMETRY_BATCH_KEYS + ("gt", "n_gt")))
            new, metrics = step(state, *args, jax.random.PRNGKey(3), out_hw=(32, 32))
        else:
            state = state.replace(ema_params=jax.tree_util.tree_map(jnp.asarray,
                                                                    variables64["params"]))
            if tp:
                state = shard_over_model_axis(state, mesh, min_channels=128)
            step = j_step.make_train_step(jm, config, tx, mesh=mesh,
                                          ema_decay=0.9, ema_ramp=2.0, donate=False)
            args = j_mesh.shard_batch(mesh, (jnp.asarray(inputs["x"]), jnp.asarray(inputs["gt"]),
                                             jnp.asarray(inputs["n_gt"])))
            new, metrics = step(state, *args)
        return ({k: float(v) for k, v in metrics.items()},
                state_dict_of("params", new.params), state_dict_of("batch_stats", new.batch_stats),
                None if geometry else state_dict_of("params", new.ema_params))


def _assert_step_matches(got_metrics, got, got_ema, want):
    metrics, params, stats, ema = want
    np.testing.assert_allclose(got_metrics["loss"], metrics["loss"], rtol=1e-6)
    for k, v in metrics.items():
        np.testing.assert_allclose(got_metrics[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    for key, w in params.items():
        np.testing.assert_allclose(got[key], w, atol=1e-5, err_msg=key)
    for key, w in stats.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-9, atol=1e-12, err_msg=key)
    if ema is not None:
        for key, w in ema.items():
            np.testing.assert_allclose(got_ema[key], w, atol=1e-5, err_msg=key)


def test_data_parallel_step_matches_the_jax_mesh_step(jobs, variables64, inputs):
    want = _jax_step(variables64, inputs, j_mesh.create_mesh(n_data=2, n_model=1))
    infos, arrays, _ = _ranks(jobs, "steps", 2)
    assert infos[0]["dp_metrics"] == infos[1]["dp_metrics"]
    for a in arrays:
        _assert_step_matches(infos[0]["dp_metrics"], _prefixed(a, "dp"),
                             _prefixed(a, "dp_ema"), want)


def test_data_parallel_geometry_step_matches_the_jax_mesh_step(jobs, variables64, inputs):
    want = _jax_step(variables64, inputs, j_mesh.create_mesh(n_data=2, n_model=1),
                     geometry=True)
    infos, arrays, _ = _ranks(jobs, "steps", 2)
    assert infos[0]["geometry_metrics"] == infos[1]["geometry_metrics"]
    _assert_step_matches(infos[0]["geometry_metrics"], _prefixed(arrays[1], "geometry"),
                         None, want)


def test_remat_under_two_ranks_matches_the_plain_step(jobs):
    """Remat's recompute reuses the first pass's global statistics and calls
    the same collectives in the backward: the step equals the plain one."""
    infos, arrays, _ = _ranks(jobs, "steps", 2)
    np.testing.assert_allclose(infos[0]["remat_metrics"]["loss"],
                               infos[0]["dp_metrics"]["loss"], rtol=1e-12)
    for a in arrays:
        for prefix in ("", "_ema"):
            plain, remat = _prefixed(a, "dp" + prefix), _prefixed(a, "remat" + prefix)
            for key, v in plain.items():
                np.testing.assert_allclose(remat[key], v, rtol=0, atol=1e-12, err_msg=key)


def test_tensor_parallel_step_matches_jax_and_the_data_parallel_step(jobs, variables64,
                                                                     inputs):
    """Mesh 1x2 at ``min_channels`` 128: the split tensors are the ones JAX
    shards (by flax path), and the step equals JAX's TP step and the
    port's DP step."""
    mesh = j_mesh.create_mesh(n_data=1, n_model=2)
    want = _jax_step(variables64, inputs, mesh, tp=True)
    jax_split = set()
    for collection in ("params", "batch_stats"):
        flags = jax.tree_util.tree_map(
            lambda leaf: "model" in str(_leaf_sharding(leaf, mesh, 128).spec),
            variables64[collection])
        jax_split |= {k for k, v in flax_to_state_dict({collection: flags}).items() if v.item()}
    infos, arrays, _ = _ranks(jobs, "steps", 2)
    assert jax_split and set(infos[0]["tp_split_tensors"]) == jax_split
    assert infos[0]["tp_metrics"] == infos[1]["tp_metrics"]
    for a in arrays:
        got, got_ema = _prefixed(a, "tp"), _prefixed(a, "tp_ema")
        _assert_step_matches(infos[0]["tp_metrics"], got, got_ema, want)
        for key, v in _prefixed(a, "dp").items():
            np.testing.assert_allclose(got[key], v, atol=1e-5, err_msg=key)


def test_tensor_parallel_slim_loss_step_matches_jax_and_the_data_parallel_step(
        jobs, jax_slim_tp_step, variables64):
    """``slim_mode: loss`` under mesh 1x2 at ``min_channels`` 128, where
    gammas are split and others replicated: the loss carries the whole
    model's penalty on both ranks, and the step equals JAX's TP step with
    the same ``slim_l1`` and the port's DP step (mesh 2x1)."""
    want = jax_slim_tp_step.result()
    infos, arrays, _ = _ranks(jobs, "steps", 2)
    gammas = {_gamma_key(site)
              for site in prunable_gammas(_port_model(variables64).state_dict())}
    split = gammas & set(infos[0]["tp_slim_split_tensors"])
    assert split and gammas - split
    assert infos[0]["tp_slim_metrics"] == infos[1]["tp_slim_metrics"]
    assert infos[0]["tp_slim_penalty"] == infos[1]["tp_slim_penalty"]
    np.testing.assert_allclose(infos[0]["tp_slim_penalty"], infos[0]["dp_slim_penalty"],
                               rtol=1e-12)
    # the penalty moves the loss far beyond the tolerance: counted on a
    # rank's slices alone it would show
    assert SLIM_CONFIG["slim_l1"] * infos[0]["tp_slim_penalty"] > 1e-3 * want[0]["loss"]
    for a in arrays:
        got, got_ema = _prefixed(a, "tp_slim"), _prefixed(a, "tp_slim_ema")
        _assert_step_matches(infos[0]["tp_slim_metrics"], got, got_ema, want)
        for key, v in _prefixed(a, "dp_slim").items():
            np.testing.assert_allclose(got[key], v, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(infos[0]["tp_slim_metrics"]["loss"],
                               infos[0]["dp_slim_metrics"]["loss"], rtol=1e-6)


def test_tensor_parallel_replicated_gradients_agree(jobs):
    """Gradients set to differ by rank (the card's atomic sums may round a
    replicated parameter's otherwise on each rank of a model group): after
    ``agree_replicated_gradients`` both ranks hold the first rank's for the
    replicated parameters and keep their own for their slices."""
    infos, _, _ = _ranks(jobs, "steps", 2)
    for r, info in enumerate(infos):
        assert info["agreed_replicated"] == [1.0]
        assert info["agreed_split"] == [float(r + 1)]


def test_tensor_parallel_checkpoint_holds_full_tensors(jobs):
    """The TP state's payload gathers every split tensor: both ranks write
    the same full tensors, and they load into one process with
    ``strict=True`` (model, AdamW and EMA)."""
    _, _, d = _ranks(jobs, "steps", 2)
    payloads = [torch.load(d / f"tp_payload{r}.pt", weights_only=True) for r in range(2)]
    for key, v in payloads[0]["model"].items():
        assert torch.equal(v, payloads[1]["model"][key]), key
    model = MBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35, dtype=torch.float64)
    model.load_state_dict(payloads[0]["model"], strict=True)
    from mobilenet_yolo_tpu_torch.train.state import create_train_state
    state = create_train_state(model, ema=True)
    state.optimizer.load_state_dict(payloads[0]["optimizer"])
    params = dict(model.named_parameters())
    for i, p in enumerate(model.parameters()):
        assert payloads[0]["optimizer"]["state"][i]["exp_avg"].shape == p.shape
    assert all(payloads[0]["ema"][k].shape == p.shape for k, p in params.items())


def test_sharded_predict_matches_one_process(jobs, variables64, inputs):
    dets, keep = make_predict_fn(_port_model(variables64), SMALL_YOLO_CONFIG, top_k=32)(
        torch.from_numpy(inputs["predict_x"]), torch.tensor(0.01))
    assert keep.any()
    _, arrays, _ = _ranks(jobs, "steps", 2)
    for a in arrays:
        for name in ("predict_dp", "predict_tp"):
            np.testing.assert_allclose(a[f"{name}/dets"], dets.numpy(), rtol=1e-4, atol=1e-5)
            np.testing.assert_array_equal(a[f"{name}/keep"], keep.numpy())


def test_sharded_eval_gives_every_rank_the_one_process_map(jobs, variables64, inputs):
    predict = make_predict_fn(_port_model(variables64), SMALL_YOLO_CONFIG, top_k=32)
    evals = [{"images": inputs["eval_x"][i:i + 3], "gt": inputs["eval_gt"][i:i + 3],
              "n_gt": inputs["eval_n_gt"][i:i + 3]} for i in range(0, 7, 3)]
    want = evaluate_detection(predict, evals, CLASSES, 0.01, device="cpu")
    assert 0 < want["mAP"] < 1
    infos, _, _ = _ranks(jobs, "steps", 2)
    assert infos[0]["eval"] == infos[1]["eval"]
    np.testing.assert_allclose(infos[0]["eval"]["mAP"], want["mAP"], rtol=0, atol=1e-9)
    assert infos[0]["eval"]["new_conf"] == want["new_conf"]


def test_loader_takes_its_rank_under_a_real_group(jobs):
    """``Loader(shard_by_process=None)`` in a 2-rank gloo group reads its
    rank and the world size from it, and yields the JAX loader's batches
    for that rank (``test_two_rank_split_bit_identical_to_jax`` drives the
    same slice through the seam by hand)."""
    infos, arrays, d = _ranks(jobs, "steps", 2)
    for rank, (info, a) in enumerate(zip(infos, arrays)):
        assert info["loader_slice"] == [rank, 2]
        ds = j_pipeline.DetectionDataset(j_records.RecordReader(str(d / "shard")), phase="train")
        want = j_pipeline.Loader(ds, 4, [[64, 64]], [0.5] * 3, [1.0] * 3, mosaic_num=[1], seed=3,
                                 prefetch=0, shard_by_process=True)
        want._process_slice = lambda rank=rank: (rank, 2)
        batches = list(want)
        assert len(batches) == 2
        for i, batch in enumerate(batches):
            for k in ("images", "gt", "n_gt"):
                np.testing.assert_array_equal(a[f"loader/{i}/{k}"], batch[k], err_msg=k)


def test_four_process_2x2_trainer_matches_one_process(jobs, tmp_path):
    """A 2x2 mesh (data x model): each rank's half of the batch, its half of
    the large layers' channels; the epoch, the eval and a checkpoint."""
    infos, _, d = _ranks(jobs, "trainer", 4)
    for key in ("loss", "avg_iou", "mAP", "val_conf"):
        assert len({info[key] for info in infos}) == 1, (key, infos)
    assert infos[0]["split_tensors"] > 0
    data = dict(np.load(d / "batches.npz"))
    cfg = json.load(open(d / "config.json"))
    model = MBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cfg, CLASSES, TrainerConfig(
        epochs=1, learning_rate=1e-3, checkpoint_dir=str(tmp_path), eval_every=1, nms_top_k=32),
        verbose=False, device="cpu")
    stats = trainer.train_epoch([{"images": data["x"][s:s + 8], "gt": data["gt"][s:s + 8],
                                  "n_gt": data["n_gt"][s:s + 8], "count": 8}
                                 for s in (0, 8)], 0)
    mAP, _ = trainer.evaluate([{"images": data["x"][:8], "gt": data["gt"][:8],
                                "n_gt": data["n_gt"][:8], "count": 8}])
    np.testing.assert_allclose(infos[0]["loss"], stats["loss"], rtol=1e-6)
    np.testing.assert_allclose(infos[0]["avg_iou"], stats["avg_iou0"] + stats["avg_iou1"],
                               rtol=1e-6)
    np.testing.assert_allclose(infos[0]["mAP"], mAP, rtol=0, atol=1e-9)
    assert infos[0]["val_conf"] == trainer.state.val_conf
    raw = CheckpointManager(str(d / "ckpt")).restore_raw(1)
    MBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35,
             dtype=torch.float64).load_state_dict(raw["model"], strict=True)


def test_cli_train_two_processes(jobs):
    """``cli.train --coordinator/--num-processes/--process-id --mesh 2``: both
    ranks train two epochs in lockstep, evaluate, rank 0 writes the
    checkpoints, which load in one process."""
    job, d = jobs["cli"]
    outs = job.wait()
    assert "torch.distributed: process 0 of 2" in outs[0]
    assert "torch.distributed: process 1 of 2" in outs[1]
    assert "best mAP" in outs[0] and "best mAP" not in outs[1]
    ck = CheckpointManager(str(d / "ck"))
    assert ck.all_steps() == [1, 2]
    raw = ck.restore_raw(2)
    assert raw["epoch"] == 2
    from mobilenet_yolo_tpu_torch.models import build_model
    model = build_model({"yolo": {"num_classes": 4, "num_anchors": 3}}, device="cpu")
    model.load_state_dict(raw["model"], strict=True)
    rows = (d / "ck" / "log.txt").read_text().strip().splitlines()
    assert len(rows) == 3 and np.isfinite(float(rows[2].split("\t")[1]))
