"""One rank of a multi-process job for ``tests/test_torch_multiprocess.py``.

Not a test module (no ``test_`` prefix) and imports no JAX: the parent
test writes the inputs (the JAX package's weights as an ``.npz``, the
batches, the config) into a directory, starts every rank on localhost
with gloo, and compares what each rank writes (``rank<r>.npz`` and
``rank<r>.json``) with the JAX mesh and with one process.

    python tests/_torch_mp_worker.py --job steps|trainer --rank R --world N \\
        --port P --dir DIR

* ``steps`` (2 ranks): one data-parallel plain step (mesh 2x1), the same
  with remat, one data-parallel geometry step, one tensor-parallel step
  (mesh 1x2, ``min_channels`` 128) with its checkpoint payload, the plain
  step with ``slim_mode: loss`` under both meshes, the
  sharded predict under both meshes and ``evaluate_detection`` under the
  2x1 mesh, float64 weights; then an epoch of the ``Loader``, which finds
  its rank and world size in the group.
* ``trainer`` (4 ranks): a 2x2 ``Trainer``: one epoch of two steps, one
  evaluation and one checkpoint, float64.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from mobilenet_yolo_tpu_torch.convert import load_flax_variables
from mobilenet_yolo_tpu_torch.data.pipeline import DetectionDataset, Loader
from mobilenet_yolo_tpu_torch.data.records import RecordReader
from mobilenet_yolo_tpu_torch.eval.detector import make_predict_fn
from mobilenet_yolo_tpu_torch.eval.evaluator import evaluate_detection
from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
from mobilenet_yolo_tpu_torch.parallel import create_mesh, global_batch, shard_over_model_axis
from mobilenet_yolo_tpu_torch.parallel.sharding import agree_replicated_gradients, split_tensors
from mobilenet_yolo_tpu_torch.prune import slim_penalty
from mobilenet_yolo_tpu_torch.tools_io import load_params_npz
from mobilenet_yolo_tpu_torch.train import (GEOMETRY_BATCH_KEYS, create_train_state,
                                            make_geometry_train_step, make_train_step)
from mobilenet_yolo_tpu_torch.train.checkpoints import state_payload
from mobilenet_yolo_tpu_torch.train.loop import Trainer, TrainerConfig

torch.set_num_threads(1)


def _model(variables: dict | None, remat: bool = False, dtype=torch.float64) -> MBv2YOLO:
    model = MBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35, remat=remat, dtype=dtype,
                     generator=torch.Generator().manual_seed(0))
    return model if variables is None else load_flax_variables(model, variables)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).copy())


def _state_arrays(prefix: str, sd: dict) -> dict:
    return {f"{prefix}/{k}": v.detach().cpu().numpy() for k, v in sd.items()}


def job_steps(rank: int, d: str) -> dict:
    cfg = json.load(open(os.path.join(d, "config.json")))
    params, batch_stats = load_params_npz(os.path.join(d, "weights.npz"))
    variables = {"params": params, "batch_stats": batch_stats}
    data = dict(np.load(os.path.join(d, "batches.npz")))
    mesh_dp = create_mesh(2, 1)
    mesh_tp = create_mesh(1, 2)
    out, info = {}, {}

    batch = (_t(data["x"]), _t(data["gt"]), _t(data["n_gt"]))
    for name, remat in (("dp", False), ("remat", True)):
        model = _model(variables, remat)
        state = create_train_state(model, ema=True)
        step = make_train_step(model, cfg, ema_decay=0.9, ema_ramp=2.0, mesh=mesh_dp)
        _, metrics = step(state, *global_batch(mesh_dp, batch))
        info[f"{name}_metrics"] = {k: float(v) for k, v in metrics.items()}
        out.update(_state_arrays(name, model.state_dict()))
        out.update(_state_arrays(f"{name}_ema", state.ema))

    model = _model(variables)
    state = create_train_state(model)
    step = make_geometry_train_step(model, cfg, fused_aug=False, dtype=torch.float64,
                                    mesh=mesh_dp)
    geom = global_batch(mesh_dp, tuple(_t(data[f"geo_{k}"]) for k in GEOMETRY_BATCH_KEYS)
                        + (_t(data["geo_gt"]), _t(data["geo_n_gt"])))
    _, metrics = step(state, *geom, 3, out_hw=(32, 32))
    info["geometry_metrics"] = {k: float(v) for k, v in metrics.items()}
    out.update(_state_arrays("geometry", model.state_dict()))

    model = _model(variables)
    state = create_train_state(model, ema=True)
    shard_over_model_axis(state, mesh_tp, min_channels=128)
    info["tp_split_tensors"] = sorted(split_tensors(model))
    step = make_train_step(model, cfg, ema_decay=0.9, ema_ramp=2.0, mesh=mesh_tp)
    _, metrics = step(state, *global_batch(mesh_tp, batch))
    info["tp_metrics"] = {k: float(v) for k, v in metrics.items()}
    payload = state_payload(state)
    out.update(_state_arrays("tp", payload["model"]))
    out.update(_state_arrays("tp_ema", payload["ema"]))
    torch.save(payload, os.path.join(d, f"tp_payload{rank}.pt"))
    # gradients that differ by rank, as the card's atomic sums may leave a
    # replicated parameter's: the replicated ones become the first rank's
    split = split_tensors(model)
    for p in model.parameters():
        p.grad = torch.full_like(p, float(rank + 1))
    agree_replicated_gradients(model, mesh_tp)
    for kind, names in (("replicated", lambda n: n not in split), ("split", lambda n: n in split)):
        info[f"agreed_{kind}"] = sorted({float(v) for n, p in model.named_parameters()
                                         if names(n) for v in (p.grad.min(), p.grad.max())})

    # slim_mode loss (slim_config.json) under both meshes: under 1x2 the
    # penalty is the whole model's on both ranks
    slim_cfg = json.load(open(os.path.join(d, "slim_config.json")))
    for name, mesh in (("dp_slim", mesh_dp), ("tp_slim", mesh_tp)):
        model = _model(variables)
        state = create_train_state(model, ema=True)
        shard_over_model_axis(state, mesh, min_channels=128)
        info[f"{name}_penalty"] = float(slim_penalty(model))
        step = make_train_step(model, slim_cfg, ema_decay=0.9, ema_ramp=2.0, mesh=mesh)
        _, metrics = step(state, *global_batch(mesh, batch))
        info[f"{name}_metrics"] = {k: float(v) for k, v in metrics.items()}
        payload = state_payload(state)
        out.update(_state_arrays(name, payload["model"]))
        out.update(_state_arrays(f"{name}_ema", payload["ema"]))
    info["tp_slim_split_tensors"] = sorted(split_tensors(model))

    images = _t(data["predict_x"])
    val_conf = torch.tensor(0.01)
    for name, mesh in (("predict_dp", mesh_dp), ("predict_tp", mesh_tp)):
        model = _model(variables)
        if mesh.n_model > 1:
            shard_over_model_axis(model, mesh, min_channels=128)
        predict = make_predict_fn(model, cfg, top_k=32, mesh=mesh)
        dets, keep = predict(global_batch(mesh, images), val_conf)
        out[f"{name}/dets"], out[f"{name}/keep"] = dets.numpy(), keep.numpy()

    model = _model(variables)
    predict = make_predict_fn(model, cfg, top_k=32, mesh=mesh_dp)
    evals = [{"images": data["eval_x"][i:i + 3], "gt": data["eval_gt"][i:i + 3],
              "n_gt": data["eval_n_gt"][i:i + 3]} for i in range(0, len(data["eval_x"]), 3)]
    res = evaluate_detection(predict, evals, ["bg", "a", "b", "c"], 0.01, device="cpu",
                             mesh=mesh_dp)
    info["eval"] = {"mAP": res["mAP"], "new_conf": res["new_conf"]}
    # the loader under the real group: it takes this rank's slice itself
    loader = Loader(DetectionDataset(RecordReader(os.path.join(d, "shard")), phase="train"), 4,
                    [[64, 64]], [0.5] * 3, [1.0] * 3, mosaic_num=[1], seed=3, prefetch=0)
    info["loader_slice"] = list(loader._process_slice())
    for i, batch in enumerate(loader):
        for k in ("images", "gt", "n_gt"):
            out[f"loader/{i}/{k}"] = batch[k]
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    return info


def job_trainer(rank: int, d: str) -> dict:
    cfg = json.load(open(os.path.join(d, "config.json")))
    data = dict(np.load(os.path.join(d, "batches.npz")))
    mesh = create_mesh(2, 2)
    tcfg = TrainerConfig(epochs=1, learning_rate=1e-3, checkpoint_dir=os.path.join(d, "ckpt"),
                         eval_every=1, nms_top_k=32)
    trainer = Trainer(_model(None), cfg, ["bg", "a", "b", "c"], tcfg,
                      mesh=mesh, verbose=False, device="cpu")
    bs, local = 8, 8 // mesh.n_data
    rows = slice(mesh.data_index * local, (mesh.data_index + 1) * local)

    def train():
        for b in range(2):
            sl = slice(b * bs, (b + 1) * bs)
            yield {"images": data["x"][sl][rows], "gt": data["gt"][sl][rows],
                   "n_gt": data["n_gt"][sl][rows], "count": local}

    def evals():
        yield {"images": data["x"][:bs], "gt": data["gt"][:bs], "n_gt": data["n_gt"][:bs],
               "count": bs}

    stats = trainer.train_epoch(train(), 0)
    mAP, _ = trainer.evaluate(evals())
    trainer.ckpt.save(1, trainer.state, mAP=mAP)
    return {"loss": stats["loss"], "avg_iou": stats["avg_iou0"] + stats["avg_iou1"],
            "mAP": mAP, "val_conf": trainer.state.val_conf,
            "split_tensors": len(split_tensors(trainer.model))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--job", choices=["steps", "trainer"], required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{args.port}",
                            world_size=args.world, rank=args.rank,
                            timeout=datetime.timedelta(seconds=300))
    info = {"steps": job_steps, "trainer": job_trainer}[args.job](args.rank, args.dir)
    with open(os.path.join(args.dir, f"rank{args.rank}.json"), "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
