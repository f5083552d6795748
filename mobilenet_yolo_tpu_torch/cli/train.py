"""Training CLI — same flag surface as the reference train.py:452-485 (port
of ``mobilenet_yolo_tpu/cli/train.py``):

    python -m mobilenet_yolo_tpu_torch.cli.train -y <data.yaml> -c <ckptdir> [--device-geometry]

Extras over the reference: ``--synthetic`` trains on generated data (smoke
runs without a dataset), ``--backbone {mbv2,mbv3,mbv3_macc}`` selects the
detector family, and NNI tuner params merge automatically when running
inside an NNI trial (train.py:487-499 semantics via train/hpo.py).

The run is on ``--device`` (default ``cuda``, which raises without a card;
``cpu`` when asked). ``--slim-l1`` / ``--slim-mode`` train with Network
Slimming (``prune.py``; ``tools/prune.py`` cuts the result, and
``--init-from <out>/params.npz`` with the cut's data yaml fine-tunes it).

Several processes, one a device (``parallel/mesh.py``): start one
process per rank with ``--coordinator host:port --num-processes N
--process-id r``, or launch them with ``torchrun`` (its environment is
read when no coordinates are given). ``--mesh`` (default ``auto``: data
parallelism over every rank) shapes them: ``N`` or ``NxM`` (data x model).
The backend is NCCL on the card and gloo on the CPU. Each rank loads its
rows of every global batch (``--batch-size`` is the global batch) and the
whole eval set; rank 0 prints, logs and writes the checkpoints.
``-o/--export`` is accepted
and unused, as in JAX: export is ``tools/export.py`` (item 7). ``-j N``
builds batches in N worker processes (``data/workers.py:WorkerLoader``,
the port's ``GrainLoader``); ``--bf16`` runs the steps and predict under
bf16 autocast; TensorBoard events go to ``./tensorboard`` in the working
directory, as in JAX.
"""

from __future__ import annotations

import argparse
import os

from mobilenet_yolo_tpu_torch.config import default_data_yaml


def get_params(argv=None):
    parser = argparse.ArgumentParser(description="CUDA YOLO Training")
    parser.add_argument("-y", "--data_yaml", dest="data_yaml",
                        default=default_data_yaml(),
                        type=str, metavar="PATH")
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--weight-decay", "--wd", dest="weight_decay",
                        default=0.0004, type=float)
    parser.add_argument("--learning_rate", default=0.0007, type=float)
    parser.add_argument("--warm-up", "--warmup", dest="warm_up", default=[],
                        type=float, nargs="*")
    parser.add_argument("--epochs", default=300, type=int)
    parser.add_argument("--schedule", type=int, nargs="+",
                        default=[100, 170, 240])
    parser.add_argument("--resume", default="", type=str, metavar="PATH")
    parser.add_argument("-c", "--checkpoint", default="checkpoint", type=str)
    parser.add_argument("-o", "--export", default="checkpoint", type=str,
                        help="accepted and unused, as in the JAX CLI (export is "
                             "tools/export.py)")
    parser.add_argument("-e", "--evaluate", action="store_true")
    parser.add_argument("--mosaic_num", default=None, type=int, nargs="*")
    parser.add_argument("--ignore_thresh_1", default=None, type=float)
    parser.add_argument("--ignore_thresh_2", default=None, type=float)
    parser.add_argument("--iou_thresh", default=None, type=float)
    parser.add_argument("--expand_scale", default=None, type=float)
    parser.add_argument("--iou_weighting", default=None, type=float)
    parser.add_argument("--backbone", default="mbv2",
                        choices=["mbv2", "mbv3", "mbv3_macc"])
    parser.add_argument("--batch-size", default=None, type=int)
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 compute under autocast (f32 params + f32 loss "
                             "numerics)")
    parser.add_argument("--host-normalize", action="store_true",
                        help="normalize images on host (default: ship uint8"
                             " and normalize on device, which is faster)")
    parser.add_argument("--device-pixel-aug", action="store_true",
                        help="run the photometric color jitter on device"
                             " (ops/device_augment.py) instead of the host;"
                             " the imgaug noise trio stays host-side with"
                             " reference probabilities. Jitter op order +"
                             " factors are host-planned per image (the"
                             " reference's per-image shuffle) and applied"
                             " on device in planned order")
    parser.add_argument("--device-geometry", action="store_true",
                        help="run the WHOLE augmentation pipeline on device:"
                             " expand/crop/flip/mosaic composition + color"
                             " jitter + normalization inside the step"
                             " (data/geometry.py, the aug_compose kernel)."
                             " The host only decodes + stages each source."
                             " Seg datasets: /16 targets rasterize on"
                             " device too")
    parser.add_argument("--mesh", default="auto", type=str,
                        help="device mesh spec: 'auto' (default — data-"
                             "parallel over every rank of the process group),"
                             " 'none', 'N' (N-way data parallel) or 'NxM'"
                             " (N-way data x M-way tensor parallel); one"
                             " process drives one device")
    parser.add_argument("--coordinator", default=None, type=str,
                        help="multi-process coordinator address host:port"
                             " (torch.distributed's tcp:// rendezvous)")
    parser.add_argument("--num-processes", default=None, type=int,
                        help="total process count (the world size)")
    parser.add_argument("--process-id", default=None, type=int,
                        help="this process's rank")
    parser.add_argument("-j", "--num-workers", default=0, type=int,
                        help="input-pipeline worker processes (the"
                             " reference's DataLoader num_workers=4,"
                             " train.py:115-121). 0 = in-process loader"
                             " with a prefetch thread; >0 builds batches in"
                             " N spawned workers (data/workers.py)")
    parser.add_argument("--stage-size", default=0, type=int,
                        help="staging square for --device-geometry sources;"
                             " 0 (default) = adaptive: stage at each"
                             " batch's output resolution")
    # smoke-mode extras
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic data (no dataset needed)")
    parser.add_argument("--steps-per-epoch", default=8, type=int)
    parser.add_argument("--img-size", default=96, type=int)
    parser.add_argument("--init-from", default="", type=str,
                        help="npz params file (e.g. converted torch weights)")
    parser.add_argument("--profile-steps", default=0, type=int,
                        help="capture a torch.profiler trace of N warm train"
                             " steps into <tensorboard>/profile (0 = off)")
    parser.add_argument("--ema-decay", default=0.0, type=float,
                        help="EMA decay for eval weights (0 = off, "
                             "0.999-0.9999 typical); evaluation and "
                             "best-model selection use the averaged "
                             "params (beyond-reference stabilizer)")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize backbone blocks in the "
                             "backward: recompute the 6x-expanded hidden"
                             " activations instead of storing them")
    parser.add_argument("--slim-l1", default=0.0, type=float,
                        help="Network Slimming L1 strength on the prunable "
                             "BatchNorm gammas (prune.py; 0 = off, 1e-4 "
                             "typical); prune afterwards with tools/prune.py")
    parser.add_argument("--slim-mode", default="prox",
                        choices=["prox", "loss"],
                        help="prox (default): soft-threshold the gammas in "
                             "Adam's metric after each step; loss: add the "
                             "L1 term to the loss (measured to fail under "
                             "AdamW, kept for the record; prune.py)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    return parser.parse_args(argv)


def main(args, report=None):
    # ``report``: optional ReportHook override (train/hpo.py) — local HPO
    # drivers (hpo/random_search.py) record trial reports through it; the
    # default resolves NNI when present, else a no-op
    import torch

    from mobilenet_yolo_tpu_torch.config import load_config
    from mobilenet_yolo_tpu_torch.models import build_model
    from mobilenet_yolo_tpu_torch.parallel import initialize_distributed, mesh_from_spec
    from mobilenet_yolo_tpu_torch.parallel.mesh import rank, rank_device, world_size
    from mobilenet_yolo_tpu_torch.tools import tool_device
    from mobilenet_yolo_tpu_torch.train.hpo import make_report_hook
    from mobilenet_yolo_tpu_torch.train.loop import Trainer, TrainerConfig

    device = tool_device(args.device)
    # several processes: join the group before the mesh is made (a no-op
    # for one process without coordinates)
    joined = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                    device=device)
    device = rank_device(device)
    if joined:
        print(f"torch.distributed: process {rank()} of {world_size()} "
              f"({torch.distributed.get_backend()}, {device})", flush=True)

    overrides = {k: getattr(args, k) for k in (
        "ignore_thresh_1", "ignore_thresh_2", "iou_thresh", "expand_scale",
        "mosaic_num", "iou_weighting")}

    if args.synthetic:
        model_cfg = {
            "img_w": args.img_size, "img_h": args.img_size,
            "batch_size": args.batch_size or 8,
            "train_img_size": [[args.img_size, args.img_size]],
            "expand_scale": 1.5, "mosaic_num": [1], "iou_weighting": 0.02,
            "normalize": {"mean": [0.5] * 3, "std": [1.0] * 3},
            "yolo": {
                "num_classes": 4, "num_anchors": 3,
                "ignore_thresh": [0.6, 0.55], "iou_thresh": 0.55,
                "anchors": [[34, 47], [48, 40], [70, 70],
                            [10, 12], [15, 25], [24, 18]],
                "classes": 4,
                "mask": [[0, 1, 2], [3, 4, 5]],
            },
        }
        classes_name = ["background", "c1", "c2", "c3", "c4"]
        segmentation = False
    else:
        cfg = load_config(args.data_yaml, overrides)
        model_cfg = cfg.model
        classes_name = cfg.classes
        segmentation = cfg.segmentation_enabled
        if args.batch_size:
            model_cfg["batch_size"] = args.batch_size
    if args.slim_l1:
        model_cfg["slim_l1"] = args.slim_l1
        model_cfg["slim_mode"] = args.slim_mode
    if args.remat:
        model_cfg["remat"] = True

    mesh = mesh_from_spec(args.mesh, batch_size=model_cfg["batch_size"]
                          if "batch_size" in model_cfg else None)
    if mesh is not None and rank() == 0:
        print(f"device mesh: {mesh.shape}", flush=True)
    # this rank's slice of each global train batch: its data index of the
    # data axis (the ranks of one model group load the same rows)
    p_idx, n_proc = (mesh.data_index, mesh.n_data) if mesh is not None else (0, 1)
    # the init is drawn on the CPU from seed 0 and then moved, so one seed
    # gives the same weights on every device
    model = build_model(model_cfg, args.backbone, device=device,
                        generator=torch.Generator().manual_seed(0))
    tcfg = TrainerConfig(
        epochs=args.epochs, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, schedule=tuple(args.schedule),
        warm_up=tuple(int(w) for w in args.warm_up),
        checkpoint_dir=args.checkpoint,
        tensorboard_dir=(os.environ["NNI_OUTPUT_DIR"] + "/tensorboard"
                         if "NNI_OUTPUT_DIR" in os.environ else "tensorboard"),
        nms_top_k=int(model_cfg.get("nms_top_k", 512)),
        ema_decay=args.ema_decay,
        profile_steps=args.profile_steps,
    )
    device_normalize = not args.synthetic and not args.host_normalize
    device_pixel_aug = args.device_pixel_aug and device_normalize
    device_geometry = args.device_geometry and not args.synthetic
    if args.init_from:
        # before the Trainer: its average starts from the loaded weights, and
        # a tensor-parallel mesh splits them
        from mobilenet_yolo_tpu_torch.convert import load_flax_variables
        from mobilenet_yolo_tpu_torch.tools_io import load_params_npz
        params, batch_stats = load_params_npz(args.init_from)
        load_flax_variables(model, {"params": params, "batch_stats": batch_stats})
    trainer = Trainer(model, model_cfg, classes_name, tcfg,
                      segmentation=segmentation, mesh=mesh,
                      report=report or make_report_hook(),
                      device_normalize=device_normalize,
                      device_pixel_aug=device_pixel_aug,
                      device_geometry=device_geometry, device=device,
                      dtype=torch.bfloat16 if args.bf16 else None)

    if args.resume:
        # explicit resume source (reference train.py:138-153 takes a file;
        # here a checkpoint directory — its latest step is restored)
        from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager
        src = args.resume if os.path.isdir(args.resume) \
            else os.path.dirname(args.resume)
        # flexible: tolerates --ema-decay toggled between the saving and
        # resuming runs, like auto-resume
        restored = CheckpointManager(src).restore_latest_flexible(trainer.state)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint found at {args.resume}")
        trainer.state = restored
        trainer.best_acc = float(restored.best_acc)
        print(f"resumed from {src} at epoch {int(restored.epoch)}")
    elif trainer.ckpt.latest_step() is not None:
        trainer.maybe_resume()

    if args.synthetic:
        if args.num_workers > 0:
            print("note: --num-workers is ignored with --synthetic "
                  "(generated batches need no loader workers)")
        from mobilenet_yolo_tpu_torch.data.synthetic import synthetic_batches
        bs = model_cfg["batch_size"]
        epoch_counter = {"n": 0}
        # synthetic batches are deterministic in the seed, so every rank
        # generates the same global batch; the train loader keeps this
        # rank's rows, the eval loader the whole batch
        if n_proc > 1 and bs % n_proc:
            raise ValueError(f"--batch-size {bs} not divisible by "
                             f"{n_proc} processes")

        def _synthetic_epoch(seed):
            return synthetic_batches(args.steps_per_epoch, bs,
                                     args.img_size,
                                     model_cfg["yolo"]["num_classes"],
                                     seed=seed)

        def train_loader():
            epoch_counter["n"] += 1  # fresh draws every epoch
            local = bs // n_proc
            rows = slice(p_idx * local, (p_idx + 1) * local)
            for images, gt, n_gt in _synthetic_epoch(epoch_counter["n"] % 4):
                yield {"images": images[rows], "gt": gt[rows], "n_gt": n_gt[rows],
                       "count": local}

        def eval_loader():
            for images, gt, n_gt in _synthetic_epoch(epoch_counter["n"] % 4):
                yield {"images": images, "gt": gt, "n_gt": n_gt, "count": bs}
    else:
        from mobilenet_yolo_tpu_torch.config import load_yaml
        from mobilenet_yolo_tpu_torch.data.pipeline import DetectionDataset, Loader
        from mobilenet_yolo_tpu_torch.data.records import RecordReader
        data_cfg = load_yaml(args.data_yaml)
        seg_nc = int(data_cfg.get("segmentation_num_classes", 0))
        train_ds = DetectionDataset(
            RecordReader(data_cfg["trainval_dataset_path"]["lmdb"]),
            phase="train", expand_scale=model_cfg["expand_scale"],
            has_seg=segmentation, seg_num_classes=seg_nc,
            # the host always applies the imgaug noise trio (pixel_noise;
            # geometry mode defers only the additive-noise op's gaussians
            # to the device with host-sampled params) — only the
            # photometric jitter moves wholesale to the device
            apply_noise=True,
            apply_photometric=not (device_pixel_aug or device_geometry))
        # eval records carry seg maps too when segmentation is on, so the
        # evaluator can report seg mIoU alongside detection mAP
        test_ds = DetectionDataset(
            RecordReader(data_cfg["test_dataset_path"]["lmdb"]),
            phase="test", has_seg=segmentation, seg_num_classes=seg_nc)
        norm = model_cfg["normalize"]
        bs = model_cfg["batch_size"]

        # construct ONCE: Loader.__iter__ advances its epoch counter, which
        # reseeds the shuffle/augmentation plan every epoch
        loader_cls = Loader
        loader_kw = {}
        if args.num_workers > 0:
            from mobilenet_yolo_tpu_torch.data.workers import WorkerLoader
            loader_cls = WorkerLoader
            loader_kw = {"num_workers": args.num_workers}
        train_loader_obj = loader_cls(
            train_ds, bs, model_cfg["train_img_size"],
            norm["mean"], norm["std"],
            mosaic_num=model_cfg["mosaic_num"],
            output_uint8=device_normalize,
            device_geometry=device_geometry,
            stage_size=args.stage_size, process_slice=(p_idx, n_proc), **loader_kw)
        # shard_by_process=False: every rank reads the same host-complete
        # eval batches, and the sharded predict takes each rank's rows
        eval_loader_obj = Loader(test_ds, bs,
                                 [[model_cfg["img_w"], model_cfg["img_h"]]],
                                 norm["mean"], norm["std"], shuffle=False,
                                 pad_final=False,
                                 output_uint8=device_normalize,
                                 shard_by_process=False)

        def train_loader():
            return train_loader_obj

        def eval_loader():
            return eval_loader_obj

    if args.evaluate:
        mAP, aps = trainer.evaluate(eval_loader())
        if rank() == 0:
            print({"mAP": mAP, **aps})
        return mAP

    best = trainer.fit(train_loader, eval_loader)
    if rank() == 0:
        print(f"best mAP: {best:.4f}")
    return best


if __name__ == "__main__":
    from mobilenet_yolo_tpu_torch.train.hpo import get_tuner_overrides
    args = get_params()
    for k, v in get_tuner_overrides().items():
        if hasattr(args, k):
            setattr(args, k, v)
    main(args)
