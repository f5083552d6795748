"""Drive the PyTorch port's serving and training paths and its measurement
tools on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, one output line each (any failure raises and exits non-zero):

1. device   — refuses to run without CUDA; prints the card's name and power
              limit as ``nvidia-smi`` reports them.
2. build    — compiles ``mobilenet_yolo_tpu_torch/csrc/*.cu`` with nvcc; prints
              ptxas's registers and spills of every instance of the three
              tensor-core kernels (``fused_block_bf16.cu``,
              ``fused_block.cu``, ``fused_stem.cu``).
3. kernel   — the NMS suppression kernel against its plain twin on the card,
              bit-equal: random (B=128, K=256), K=60 (64x64 input), chain,
              and a full random (B=128, K=256) matrix (diagonal and lower
              triangle set: the kernel reads only the strict upper one).
4. serve    — the full-width VOC MBv2-YOLO (random weights from a seeded
              ``torch.Generator``) served through ``make_predict_fn``: batch 1
              and batch 128 at 352x352 in float32, uint8 with on-device
              normalize, and bf16. Checks that every request launched the
              kernel, that the kernel's keep equals the twin's on the
              ``over`` matrix of each request, card-vs-CPU float32 logits and
              bf16-vs-float32 logits (init weights), and the whole slice
              card-vs-CPU in float64 (served weights).
5. aug_kernels — the two augmentation kernels (``slot_aug``, ``aug_compose``)
              against their plain twins on a random geometry batch (batch
              32, 4 slots per image, stage 352 and 416; 1-tile and 4-tile
              images, flips, mean and constant fills, both hue signs,
              noise on, one seed on both sides), and the bulk statistics of
              the kernel's noise field.
6. train    — the full-width VOC MBv2-YOLO trained through
              ``make_geometry_train_step``: a few batch-32 352x352 steps in
              each aug mode (``fused_aug`` True, "split", False) in float32
              and bf16, one 416x416 step; checks the losses are finite, the
              parameters and BatchNorm statistics moved, each kernel launched
              once per step of its mode, and that the first float32 losses
              of the kernel modes agree with the plain ops' (noise on: every
              mode draws one noise stream from one seed).
7. data     — the input pipeline from JPEG shards on the card: a fabricated
              VOC tree (``tools/make_fabricated_voc.py``, 512 trainval and 64
              test images, seed 7) built into shards by ``python -m
              mobilenet_yolo_tpu_torch.cli.build_dataset`` (its own
              process; every record's labels read back against the XML,
              the native record store and the cv2 decoder checked); the
              VOC ``Loader`` (batch 32, the five buckets, mosaic [1, 4],
              prefetch 2) alone for an epoch in host float32, uint8 and
              device-geometry modes (batches/s, img/s); each mode's step fed
              one epoch of the shard's first half (``DATA_FED_RECORDS``;
              host float32 into ``make_train_step``, uint8 into
              its ``normalize`` + ``pixel_aug`` form, geometry into
              ``make_geometry_train_step`` with ``fused_aug`` True and
              "split", float32 and bf16; each mode first warmed up at every
              bucket) beside the same step on a batch resident on the card
              at 352: step ms, img/s, the card's idle share
              (``torch.profiler``, CUDA activity) and the share outside the
              steps' CUDA events;
              losses finite, parameters moved, each kernel launched once per
              step of its mode (``loader_launches``); then both kernels
              against their twins on a loader batch at each bucket (288-416)
              and again with 0xFF in the inactive slots, whose outputs must
              not move.
8. mbv3     — MobileNetV3-YOLO and MBv3-YOLO MACC-lite at the VOC contract
              (seeded init, BatchNorm calibrated): batch 128 at 352x352
              served in float32 and bf16, unfolded and folded (cuDNN
              biased convs; no MobileNetV2 fused kernel may launch), the NMS
              kernel once a request; a CPU float64 slice against the card's
              (``DETS_TOL``), folded float32 heads against unfolded
              (``FOLD_F32_REL_TOL``), bf16 printed; a plain and a geometry
              step per dtype at batch 32 (``aug_compose`` once a geometry
              step); beside these, MBv3-YOLO through ``cli.train
              --backbone mbv3`` (the fit recipe, ``MBV3_EPOCHS`` epochs; the
              loss ratio held to ``MBV3_LOSS_RATIO``, the mAP printed),
              ``cli.eval``, ``cli.infer`` and ``tools.prune --backbone
              mbv3 --ratio 0.3`` of the checkpoint, then ``cli.eval`` of the
              cut, each its own process; then one fed epoch in this process
              (img/s, idle share); the cut in this process: its mAP against
              the eval CLI's (``FIT_EVAL_MAP_TOL``, both at torch's default
              precision), its widths and parameters beside the parent's,
              b128 requests in float32 and bf16, unfolded and folded (the
              NMS kernel once a request, no MobileNetV2 fused kernel), a
              float64 slice card vs CPU (``DETS_TOL``), folded float32 heads
              against unfolded (``FOLD_F32_REL_TOL``), one geometry step
              (``aug_compose`` once); MACC-lite's head site cut in this
              process (``plan_prune`` / ``apply_prune``, its prunable gammas
              scaled by seeded factors) and served at b128 float32 with a
              float64 slice card vs CPU; b128 ms per mode and the b1
              latency of both graphs and the cut.
9. fit      — the port trained to a real mAP: ``python -m
              mobilenet_yolo_tpu_torch.cli.train`` as its own process from
              ``build/chip_smoke_fit/`` on the data phase's shards (the
              full-width MBv2-YOLO, batch 32, the recipe of
              docs/TRAINING.md:111-115 with ``--device-geometry``), 12
              epochs, then again to 24, which must resume from epoch 12;
              ``log.txt`` holds 24 finite rows, the optimizer took the
              planned steps, the TensorBoard events are there, the loss of
              epoch 24 is at most ``FIT_LOSS_RATIO`` of epoch 1's and the
              last logged mAP at least ``FIT_MIN_MAP``; ``cli.eval`` (own
              process) at the last in-run eval's gate matches the log within
              ``FIT_EVAL_MAP_TOL`` and prints its mAP at the checkpoint's
              own gate; ``cli.infer`` serves the checkpoint on a test image.
              In this process: the trained weights' test mAP in float32,
              bf16, folded float32 and folded bf16 (kernels 1-4 counted);
              the bf16 heads' error against float32 on the card held to
              ``FIT_BF16_VS_CPU`` times the same error computed on the CPU
              (autocast, the plain path) from the saved served weights and
              the same test batch, both printed with their ratio, the
              folded bf16 heads' error printed; one ``Trainer.train_epoch`` fed by
              ``Loader`` and one by ``WorkerLoader(num_workers=4)``, each
              warm at every bucket (img/s, epoch seconds, the card's idle
              share; kernel 6 once per step), and one ``Trainer.evaluate``
              (kernel 1 once per batch).
10. bdd     — the BDD100K multi-task path (detection and drivable-area
              segmentation): a fabricated BDD-style tree
              (``tools/make_fabricated_bdd.py``, 256 train and 64 test
              images, seed 11: per-image COCO JSON whose class map drops two
              of five classes, single-channel seg PNGs, its own 352x352
              3-class seg-2 model yaml) built by ``cli.build_dataset`` (its
              own process; every record's labels read back against its JSON
              after the map, its seg map against its PNG); ``cli.train
              --device-geometry`` (the segmentation geometry step, batch 32,
              ``BDD_EPOCHS`` epochs at ``BDD_LR``; the loss ratio held to
              ``BDD_LOSS_RATIO``) and ``cli.eval`` (mAP and seg mIoU, which
              must lie above the seg metrics' mIoU of every constant
              prediction, the most frequent test-map class's among them),
              each its own process; in this process the checkpoint's mAP and
              seg mIoU card vs CPU in float64 (``EVAL_MAP_TOL``; kernel 1
              once a batch), the segmentation geometry step on
              ``BDD_STEP_BATCHES`` loader batches with noise off: the
              path's step on the card in float32 (TF32 off, ``aug_compose``
              once a step, its images held to the twin's at
              ``AUG_MAX_ERR`` / ``AUG_MEAN_ERR``), and the step card vs CPU
              (float64) on the same inputs, the twin's images and seg maps,
              the card in float32 and float64, at ``BDD_STEP_RTOL`` (loss,
              ``seg_obj``, ``seg_no_obj``) on ``BDD_STEP_GATE``'s reading,
              every reading printed; the
              published BDD model (``configs/bdd100k``: 7 classes, seg 2,
              seeded, BatchNorm calibrated) served at batch 32, 416x416,
              unfolded and folded in float32 and bf16 (kernels 1-4 counted
              per request, b32 ms per mode), a float64 slice's detections
              and sigmoid seg maps card vs CPU (``DETS_TOL``), folded
              float32 heads and seg against unfolded (``FOLD_F32_REL_TOL``)
              (its block shapes are held by ``fused_kernels``).
11. dist    — data and tensor parallelism on the one card, after fit:
              two gloo ranks (``parallel/mesh.py``; NCCL refuses two ranks
              on one device) started as processes of their own, each
              loading its 8 rows of every global batch of 16 from the data
              phase's shards (the VOC loader, ``process_slice``), take the
              full-width model through ``make_geometry_train_step`` on a
              2x1 mesh: three steps in ``aug_compose`` mode and one in
              ``slot_aug`` mode, each rank's kernel under its shard's seed,
              float32 with TF32 off; held against this process stepping
              the same global batches with each half augmented under its
              rank's seed (losses, then parameters and BatchNorm
              statistics after the first step, ``DIST_*``), every rank's
              losses bit-equal, kernels 6 and 5 counted per rank. One
              tensor-parallel step (mesh 1x2) against a data-parallel one
              on the same global batch, noise off (``TP_*``), then both
              again with ``slim_mode: loss`` (``DIST_SLIM_L1``): the loss
              equal on both ranks, each rank's penalty the gathered
              model's (``DIST_PENALTY_RTOL``), ``aug_compose`` once a step
              and rank. A ``Trainer``
              on the 1x2 mesh: one epoch of two steps, its sharded eval and
              its checkpoint (full tensors, rank 0 writes), then a second
              ``Trainer`` resuming it, each rank restoring its slice
              bit-equal, and this process loading it with ``strict=True``
              (every rank's slice equal to its part). The fit checkpoint's
              sharded eval, unfolded (kernel 1) and folded (kernels 1-4),
              every rank's mAP bit-equal and within ``DIST_MAP_TOL`` of
              the fit phase's eval at the same precision (unfolded: its
              ``cli.eval``, torch's defaults; folded: its in-process
              folded float32 eval, TF32 off), launches per rank. One rank at
              world size 1 through the backend the port picks for the card
              (NCCL, ``join_process_group``): a data-parallel step against
              this process's and the sharded eval. The workers join
              through ``initialize_distributed`` / ``join_process_group``
              and run the steps in float32 with TF32 off, as this process
              does, and the evals at the precision of the eval each is held
              to. The port makes no host copy of its own for a collective;
              gloo takes the CUDA tensors.
    hpo     — the HPO sweep beside the dist phase and the slim phase's
              processes: ``python -m
              mobilenet_yolo_tpu_torch.hpo.random_search`` on the bdd
              phase's data yaml, its own process, ``HPO_TRIALS`` trials of
              ``HPO_EPOCHS`` epochs (seed ``HPO_SEED``); ``trials.json``
              holds the seeded draws (``sample_params``), one intermediate
              report per in-run eval and the final report equal to the best
              mAP; each trial's ``log.txt`` and checkpoint record its draw
              (weight decay, learning rate); each trial's seconds printed;
              in this process the best trial's checkpoint evaluated on the
              card (torch's defaults, as the trial ran) within
              ``FIT_EVAL_MAP_TOL`` of its logged best, kernel 1 once a
              batch.
12. slim    — Network Slimming: ``cli.train --slim-l1 1e-4`` (prox, the fit
              recipe) continuing the fit phase's run (``--resume``) for
              ``SLIM_EPOCHS`` epochs, the port's ``tools/prune.py``
              (``--dry-run`` on the fit phase's plain checkpoint and on the
              slim one, then ``--ratio 0.3`` and ``0.5`` on the slim one),
              the slim bottom-30% |gamma| mass held below
              ``SLIM_MASS_SHARE`` of the plain one's; ``cli.eval`` of the
              parent and both cuts unfine-tuned (the 30% cut held to
              ``SLIM_CUT30_SHARE`` of the parent's mAP); the 50% cut
              fine-tuned from its ``params.npz``; in this process the
              fine-tuned cut served folded in float32 and bf16 (mAP within
              ``SLIM_FOLD_MAP_TOL`` of unfolded; kernels 1-4 counted), a
              ``--round-to 1`` plan of the slim parent served folded (odd
              hidden widths, zero-padded for the kernels), one fed slim
              epoch (the prox step; kernel 6 counted), kernels 2-4 against
              their twins on the cut's own weights and kernels 2-3 at the
              odd widths unpadded, and the cut's folded b128 time beside
              the VOC widths'.
13. quant    — int8 PTQ of the fit phase's checkpoint: ``python -m
              mobilenet_yolo_tpu_torch.tools.quantize --eval`` as its own
              process (calibration on 4 test batches of 8, the int8
              artifact, the float vs int8 mAP A/B at the checkpoint's gate;
              ``mAP_float`` within ``FIT_EVAL_MAP_TOL`` of the same float
              arm replayed in this process as the tool runs it (torch's
              default TF32), the replay with TF32 off within it of the fit
              phase's folded float32 eval, ``cli.eval``'s mAP printed
              beside, ``mAP_int8`` above ``QUANT_MAP_SHARE`` of it,
              ``mAP_drop`` beside PERF.md's prediction); in this process
              the artifact
              (``quant.load_int8``) served through ``QuantSim`` on the
              64 test images (its mAP the tool's, kernel 1 once a batch)
              and its heads card vs CPU in float64 on 4 images
              (``QUANT_F64_REL_TOL``).
14. export   — ``python -m mobilenet_yolo_tpu_torch.tools.export --what
              aot`` of the same checkpoint at batch 8, 352x352, unfolded
              and ``--fold-bn``, each its own process; a fresh process
              (torch and the kernels package alone) loads each ``.pt2`` and
              serves the 64 test images: ``keep`` equal to the eager
              predict's, ``dets`` within ``EXPORT_DETS_TOL`` (else the first
              ``myt`` op that differs is named), kernel 1 once a batch and
              the folded program's 1 + 4 + 12 fused launches; export
              seconds, ``.pt2`` bytes, load seconds, the loaded b8 ms beside
              eager; a launch's host time through the wrapper, the op and
              the bare ctypes call. ``--what npz`` and ``tools.convert_torch
              --reverse`` of the checkpoint directory converted back by
              ``--torch`` (beside the exports), served through
              ``cli/infer.py``'s loader with equal detections.
15. fused_kernels — the three fused-block kernels of the BatchNorm-folded
              forward (``fused_stem_block0``, ``fused_inverted_residual_s2``,
              ``fused_inverted_residual``; all on the tensor cores, float32
              in three TF32 passes) against their cuDNN twins, TF32 off, in
              float32 and bf16, at the batch-128 352x352 shape of every
              backbone block of the VOC model and of the served slim50 plan
              (hidden widths that end the last 48- and 24-channel chunk
              part-full), at the batch-32 416x416 shape of every block of
              the published BDD model (``bdd416:blockN``), an unaligned
              width and odd output widths; and
              the float32 block kernel (block 16's shape) and stem kernel
              (its b128 352x352 shape) against the float64 twin.
16. serve_folded — the same VOC model folded (``fold_batchnorm``) and served
              through ``make_predict_fn``: batch 1 and 128 at 352x352 in
              float32, uint8 normalize and bf16. Checks each request
              launched the stem kernel once, the stride-2 kernel 4 times and
              the stride-1 kernel 12 times, and that the folded model's
              heads match the unfolded model's (init weights in float32 and
              bf16, served weights in float32).
17. stem_probe — the staged stem roofline kernel (``stem_probe``, stages a,
              b, c) driven through ``python -m
              mobilenet_yolo_tpu_torch.tools.probe_stem_cuda`` as a user runs
              it (a small check and the batch-128 352x352 bench, beside the
              bound, ``share_of_bound``, and for c the ``F.conv2d`` chain and
              ``vs_stage_a``, c's time over a's); checks its launches,
              then each stage against its twin at a small shape, at S=18 (odd
              S/2) and at 128x352.
18. tools   — the measurement tools at reduced iterations: ``bench_train`` at
              batch 32 float32, plain and ``--remat`` (the backward adds time
              and at least doubles the FLOPs), one remat step against the
              plain step (same loss, same BatchNorm buffers, one count each),
              ``bench_geometry --stages --fused on`` at 416,
              ``probe_aug_kernels`` and ``probe_stem``; checks they launched
              the augmentation kernels.
19. serve_pruned — the served slim50 plan (``configs/voc/slim50.yaml``,
              hidden widths off every 48- and 24-channel chunk) folded:
              heads against the unfolded model's (init weights float32 and
              bf16, calibrated float32), then a b128 request a dtype through
              ``make_predict_fn``, the fused kernels' launches counted.
20. eval    — ``evaluate_detection`` on the card against the same run on
              the CPU, float64, 23 images at batch 8 (a ragged tail), K=512:
              ``keep`` equal, mAP within 1e-9; the scan's launches counted.
21. infer   — ``python -m mobilenet_yolo_tpu_torch.cli.infer`` as its own
              process (random weights): a directory of 5 PNGs at batch 2,
              then one image; a result file per input.
22. bench   — ``python -m mobilenet_yolo_tpu_torch.bench`` as its own
              process in 2 of its 8 modes (``BENCH_PROCESS_MODES``, enough to
              show the module runs as a program; ``timing`` drives all 8 in
              this process): one JSON line each, a finite img/s, printed
              beside the card.
23. timing  — CUDA-event throughput at batch 128 (f32, bf16, u8), unfolded
              and folded, batch-1 latency, the bench itself in each of its
              modes in this process (``bench.main``: ``in_process_bench_*``,
              beside its own-process number), the train step per mode and
              dtype, and each kernel's time beside its twin's and its bound
              (each fused kernel at every block shape of the VOC and BDD
              predicts, float32 and bf16;
              the NMS scan at B=128 and B=1, K=256, and at B=8, K=512); the
              augmentation kernels' launches apart (``torch.profiler``: the
              statistics pre-pass, the compose or pixel pass) at 352 and 416, and
              ``slot_aug``'s per slot class (``probe_aug_kernels --bench
              --traffic copy|noise|color``).

The line before the last also carries the NMS scan's bound over the whole
matrix beside the strict triangle's (``whole_matrix_bound_ms``), its time
at B=1 (``b1_ms``; ``ms`` and ``b1_ms`` are CUDA events per call of the
wrapper, as for every kernel) and the kernel's own device time from
``torch.profiler`` on one ``over`` and on a pool larger than the L2
(``device_ms``, ``cold_device_ms``, ``b1_device_ms``, ``b1_cold_device_ms``),
its times at the evaluator's B=8, K=512 (``k512_b8_*``), its launches on
the eval and slim50 paths (``eval_launches``, ``slim50_launches``; the
fused kernels' ``slim50_launches`` too), ``slot_aug``'s pre-pass and pixel
pass apart and per slot class (``prepass_ms``, ``pixel_pass_ms``,
``class_ms``), the two augmentation kernels' launches on the data phase's
loader path (``loader_launches``), their worst error on its batches
(``loader_max_abs_err``) and their times on a loader batch at each bucket
beside the twin's and the bound (``loader_buckets``), the launches of the
fit phase's in-process part (``fit_launches``, kernels 1-4 and 6), those of
the mbv3 and slim phases (``mbv3_launches``, ``slim_launches``), of the
quant phase's in-process int8 graph and of the export phase's fresh
serving process (``quant_launches``, ``export_launches``), rank 0's on the
dist phase's data-parallel steps, its slim-loss steps and sharded evals
(``dist_launches``),
those of the bdd phase's in-process path (``bdd_launches``: its float64
eval, its steps and its 416x416 requests), the MBv3 cuts' path in the
mbv3 phase (``mbv3_cut_launches``), the HPO phase's eval of the best
trial (``hpo_launches``), the fused kernels' sums per b32
416x416 BDD predict (``bdd416_ms``, ``bdd416_plain_ms``,
``bdd416_library_ms``, ``bdd416_library_device_ms``, ``bdd416_bound_ms``
and their ``bdd416_bf16_*`` twins), and, for
the three fused kernels, the float32 twins' kernels alone per b128 predict
(``library_device_ms``, from
``torch.profiler``) and the float32 bound on CUDA cores (``fma_bound_ms``;
``bound_ms`` is the block kernels' own route, three TF32 passes), their
bf16 sums per b128 predict (``bf16_ms``, ``bf16_plain_ms``,
``bf16_library_ms``; ``bf16_library_device_ms``, the twins' kernels alone
from ``torch.profiler``; ``bf16_bound_ms``) and worst bf16 error relative
to the largest output (``bf16_max_rel_err``).

A ``[time]`` line after each group of phases gives its wall seconds and
the run's so far. The subprocess calls that read none of each other's
files (the evals and the infer of ``fit``, ``mbv3`` and ``infer``;
``slim``'s dry runs and cuts, then its evals and fine-tune; ``export``'s
two programs, npz and reverse conversion) run at once, and some phases'
processes run beside other work that is checked, not timed: both
fabricated trees and their shards beside the build and the first phases,
``mbv3``'s CLIs beside its requests and steps, ``bdd``'s beside the fit
phase's processes, ``slim``'s and the HPO sweep beside the dist phase.

    python3 chip_smoke.py --only fit bdd    # the build, then these phases

runs the named phases alone (of ``mbv3``, ``fit``, ``bdd``, ``dist``,
``hpo``; ``mbv3`` and ``fit`` on freshly built VOC shards, ``dist`` after
``fit``) and prints neither the kernels line nor the result.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX; yaml is read
through the port's ``config.py`` (the slim50 plan, the VOC class names,
the data yaml) and PIL only to write the infer phase's images and read
the data phase's JPEG sizes. The subprocess phases write under ``build/``
(gitignored).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from torch.utils._python_dispatch import TorchDispatchMode

from mobilenet_yolo_tpu_torch import bench, prune, quant
from mobilenet_yolo_tpu_torch.cli.infer import load_variables
from mobilenet_yolo_tpu_torch.config import (TRAIN_BUCKETS, VOC_CONFIG, default_data_yaml,
                                             load_config, load_yaml, prune_plan)
from mobilenet_yolo_tpu_torch.convert import load_flax_variables
from mobilenet_yolo_tpu_torch.data import augment as host_augment
from mobilenet_yolo_tpu_torch.data import records
from mobilenet_yolo_tpu_torch.data.dataset_builder import (parse_coco_json, parse_voc_xml,
                                                            to_yolo_labels)
from mobilenet_yolo_tpu_torch.data.pipeline import (DetectionDataset, Loader, _decode_seg,
                                                    batch_to_device)
from mobilenet_yolo_tpu_torch.data.workers import WorkerLoader
from mobilenet_yolo_tpu_torch.eval import evaluate_detection, make_predict_fn
from mobilenet_yolo_tpu_torch.kernels import _build
from mobilenet_yolo_tpu_torch.kernels import fused_block as fb
from mobilenet_yolo_tpu_torch.kernels import nms_suppress as nms_kernel
from mobilenet_yolo_tpu_torch.kernels.aug_compose import aug_compose, aug_compose_reference
from mobilenet_yolo_tpu_torch.kernels.nms_suppress import suppress, suppress_reference
from mobilenet_yolo_tpu_torch.kernels.slot_aug import slot_aug, slot_aug_reference
from mobilenet_yolo_tpu_torch.kernels.stem_probe import STAGES, stem_probe, stem_probe_reference
from mobilenet_yolo_tpu_torch.models import build_model, mobilenetv2
from mobilenet_yolo_tpu_torch.models.bn_fold import calibrate_bn, fold_batchnorm
from mobilenet_yolo_tpu_torch.ops import nms as nms_ops
from mobilenet_yolo_tpu_torch.ops.nms import _suppression_matrix
from mobilenet_yolo_tpu_torch.ops.seg_metrics import SegMetricAccumulator
from mobilenet_yolo_tpu_torch.parallel import create_mesh, global_batch
from mobilenet_yolo_tpu_torch.parallel.mesh import join_process_group, rank_device
from mobilenet_yolo_tpu_torch.tools import (bench_geometry, bench_train, probe_aug_kernels,
                                            probe_nms, probe_stem, probe_stem_cuda)
from mobilenet_yolo_tpu_torch.tools.probe_fused_tiles import block_shapes, kernel_ms as profiled_ms
from mobilenet_yolo_tpu_torch.train import (GEOMETRY_BATCH_KEYS, create_train_state,
                                            make_geometry_train_step, make_train_step,
                                            random_geometry_batch)
from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager, served_state_dict
from mobilenet_yolo_tpu_torch.train.loop import Trainer, TrainerConfig
from mobilenet_yolo_tpu_torch.train.state import TrainState
from mobilenet_yolo_tpu_torch.ops.device_augment import seg_compose
from mobilenet_yolo_tpu_torch.train.step import augment_geometry
from mobilenet_yolo_tpu_torch.train.synthetic import random_program
from mobilenet_yolo_tpu_torch.utils.profiling import (BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S,
                                                      TF32_FLOPS, bound_ms, device_ms,
                                                      kernel_ms_by_name, request_ms)

SEED = 0
BATCH = 128
TRAIN_BATCH = 32
TRAIN_SIZES = (352, 416)  # the step's main bucket and the multiscale maximum
TRAIN_STEPS = 3
AUG_SEED = 1234
SIZE = 352
VAL_CONF = 0.3
IOU = 0.45
# float32 logits, card (TF32 off) vs CPU, relative to the largest logit:
# only summation order differs
F32_REL_TOL = 1e-4
# bf16 logits vs float32, relative to the largest logit: an 8-bit mantissa
# (2^-8 = 3.9e-3) rounds every layer
BF16_REL_TOL = 5e-2
# kept detections (boxes and scores in [0, 1]) of the float64 slice,
# card vs CPU, after the heads' cast to float32 for decode
DETS_TOL = 1e-6
# augmentation kernels vs twins on the bf16 output in [0, 255]: both
# compute in float32 and round once, so a few float32 ulp may tip one
# rounding by one bf16 spacing (1.0 in [128, 256)), and rarely
AUG_MAX_ERR = 1.0
AUG_MEAN_ERR = 0.05
# noise field of mid-grey slots at std 12: bulk mean within 0.02 (about 10
# standard errors of 30 M draws), bulk std within 0.5%; per slot the mean
# within 0.2 and the std within 2% (a shared-plane slot draws 124k values)
NOISE_STD = 12.0
NOISE_BULK_MEAN_TOL = 0.02
NOISE_BULK_STD_REL = 5e-3
NOISE_SLOT_MEAN_TOL = 0.2
NOISE_SLOT_STD_REL = 2e-2
# kernel-mode vs plain-op step loss, same weights, batch and noise: the
# kernels round their images (full) or slots (split) to bf16, at most 0.5
# of 255 per rounding
AUG_MODE_LOSS_RTOL = 2e-2
# stem probe kernel vs twin: ``probe_stem_cuda.tolerance``, one bf16
# spacing of the largest output for stages a and b (thousands of floats
# summed in another order, rounded once to bf16), 2^-8 of the largest
# output for stage c (the kernel's three TF32 passes and the twin's rounded
# products sum the 27 taps in other orders, a few float32 ulp apart, and
# round once to bf16: a rounding may tip by one bf16 spacing)
STEM_SHAPES = ((4, 64), (3, 18), (BATCH, SIZE))  # (B, S): small, odd S/2, the bench shape
STEM_ITERS = 20
# remat vs plain first loss on the same weights and batch, float32 with
# TF32 off: only the backward is scheduled differently
REMAT_LOSS_RTOL = 1e-5
# probe_stem's b, c and d folds against formulation a, all four bf16 cuDNN
# convs of the same products summed in other orders: one bf16 rounding
# may tip, at most 2^-7 of the largest output
STEM_FOLD_REL_TOL = 2.0 ** -7
TOOLS_ITERS = 3
KERNELS = {
    "nms_suppress": ("mobilenet_yolo_tpu_torch/csrc/nms_suppress.cu",
                     "mobilenet_yolo_tpu/kernels/pallas_nms.py:59"),
    "slot_aug": ("mobilenet_yolo_tpu_torch/csrc/slot_aug.cu",
                 "mobilenet_yolo_tpu/kernels/pallas_aug.py:216"),
    "aug_compose": ("mobilenet_yolo_tpu_torch/csrc/aug_compose.cu",
                    "mobilenet_yolo_tpu/kernels/pallas_aug.py:388"),
    "fused_inverted_residual": ("mobilenet_yolo_tpu_torch/csrc/fused_block.cu",
                                "mobilenet_yolo_tpu/kernels/pallas_fused.py:131"),
    "fused_inverted_residual_s2": ("mobilenet_yolo_tpu_torch/csrc/fused_block.cu",
                                   "mobilenet_yolo_tpu/kernels/pallas_fused.py:228"),
    "fused_stem_block0": ("mobilenet_yolo_tpu_torch/csrc/fused_stem.cu",
                          "mobilenet_yolo_tpu/kernels/pallas_fused.py:389"),
    "stem_probe": ("mobilenet_yolo_tpu_torch/csrc/stem_probe.cu",
                   "tools/probe_stem_pallas.py:126"),
}
BF16_SOURCES = {"fused_inverted_residual": "mobilenet_yolo_tpu_torch/csrc/fused_block_bf16.cu",
                "fused_inverted_residual_s2": "mobilenet_yolo_tpu_torch/csrc/fused_block_bf16.cu",
                "fused_stem_block0": "mobilenet_yolo_tpu_torch/csrc/fused_stem.cu"}
FUSED = {"fused_inverted_residual": fb.fused_inverted_residual,
         "fused_inverted_residual_s2": fb.fused_inverted_residual_s2,
         "fused_stem_block0": fb.fused_stem_block0}
LAUNCH_COUNTERS = (suppress, slot_aug, aug_compose, *FUSED.values(), stem_probe)
# fused kernel vs twin, relative to the largest output. float32: only the
# order of summation differs (the block kernel's three TF32 passes keep
# float32's accuracy and sum the project over 24-channel chunks; up to 960
# terms at 6e-8 each is 5.8e-5 at worst). bf16
# (``fb.BF16_REL_TOL``): the block kernel rounds where pallas_fused.py does
# (float32 hidden and depthwise, the depthwise output rounded to bf16, one
# output rounding), the twin also rounds the hidden tensor, the project's
# output and the residual sum (2^-9 relative each); the two outputs may sit
# one bf16 spacing of the largest (2^-7) apart plus a few roundings. The
# stem kernel keeps float32 inside and rounds its output once
FUSED_F32_REL_TOL = 1e-4
FUSED_BF16_REL_TOL = fb.BF16_REL_TOL
# the float32 block and stem kernels against the float64 twin, relative to
# the largest output: float32's own rounding (a few 1e-7; one TF32 pass
# would sit at 2-5e-4)
FUSED_F64_REL_TOL = 1e-5
# folded and fused heads vs the unfolded model's on the served (calibrated)
# weights in float32: the calibrated random network amplifies float32
# rounding ~450-fold (2.7e-5 against float64), and folding rounds each
# weight once more and the kernels sum in another order
FOLD_F32_REL_TOL = 1e-3
# folded heads vs the unfolded float32 heads on the init weights (which
# contract, so each comparison sees the rounding of a few layers)
INIT_FOLD_CASES = [("f32", None, F32_REL_TOL), ("bf16", torch.bfloat16, BF16_REL_TOL)]
# per fused launch on the folded predict path, at the MobileNetV2 widths
FUSED_PER_REQUEST = {"fused_stem_block0": 1, "fused_inverted_residual_s2": 4,
                     "fused_inverted_residual": 12}
MODES = {"full": True, "split": "split", "plain": False}
DTYPES = {"f32": None, "bf16": torch.bfloat16}
ROOT = Path(__file__).resolve().parent
SLIM50 = default_data_yaml("voc/slim50.yaml")
# the evaluator on the card: 23 images in batches of 8 (a ragged 7 last),
# ``cli/eval.py``'s top_k; float64 on both sides, so the mAP agrees to
# float64 rounding of the metric's own sums
EVAL_IMAGES = 23
EVAL_BATCH = 8
EVAL_TOP_K = 512
EVAL_GT_ROWS = 8
EVAL_MAP_TOL = 1e-9
INFER_IMAGES = 5
SUBPROCESS_TIMEOUT = 600
# the bench's modes, each run through ``bench.main`` in this process by
# ``phase_timing``; BENCH_PROCESS_MODES also as their own process (python -m
# mobilenet_yolo_tpu_torch.bench), enough to show the module runs as a
# program (each process costs ~12 s of start-up and warm-up on the card)
BENCH_MODES = {
    "f32": ["--dtype", "f32"],
    "bf16": ["--dtype", "bf16"],
    "f32_fold": ["--dtype", "f32", "--fold-bn"],
    "bf16_fold": ["--dtype", "bf16", "--fold-bn"],
    "f32_fold_slim50": ["--dtype", "f32", "--fold-bn", "--prune-yaml", SLIM50],
    "bf16_fold_slim50": ["--dtype", "bf16", "--fold-bn", "--prune-yaml", SLIM50],
    "f32_fold_u8": ["--dtype", "f32", "--fold-bn", "--input-dtype", "u8"],
    "b1_f32": ["--batch-size", "1", "--dtype", "f32"],
}
BENCH_PROCESS_MODES = ("b1_f32", "bf16_fold_slim50")
# the data phase: a fabricated VOC tree (tools/make_fabricated_voc.py: VOC
# XML and JPEGs of 240-480 px sides, difficult boxes), its shards built by
# the port's build_dataset CLI, and the VOC loader over them: batch 32, the
# five buckets, mosaic [1, 4], prefetch 2
DATA_DIR = ROOT / "build" / "chip_smoke_voc"
DATA_TRAIN = 512
DATA_TEST = 64
DATA_SEED = 7
DATA_PREFETCH = 2
# the loader's three modes: DetectionDataset and Loader arguments
LOADER_MODES = {"host": ({}, {}),
                "u8": ({"apply_photometric": False}, {"output_uint8": True}),
                "geometry": ({"apply_photometric": False}, {"device_geometry": True})}
# loader-fed training runs: (loader mode, fused_aug of the geometry step, dtype)
FED_MODES = {"host_f32": ("host", None, None), "u8_f32": ("u8", None, None),
             "full_f32": ("geometry", True, None), "split_f32": ("geometry", "split", None),
             "full_bf16": ("geometry", True, torch.bfloat16),
             "split_bf16": ("geometry", "split", torch.bfloat16)}
# steps of each mode on a batch resident on the card, after a warmup step
DATA_REFERENCE_STEPS = 5
# each mode's fed epoch runs over the shard's first half (8 steps of 32)
DATA_FED_RECORDS = DATA_TRAIN // 2


# the fit phase: the port's train CLI on the data phase's shards with the
# recipe of docs/TRAINING.md:111-115 (warm-up 1 2, schedule 40 50, the
# geometry step), 12 epochs, then resumed to 24 in a second process; bars
# set before any run (the JAX package's run of the recipe logged mAP 0.197
# at epoch 10 and 0.656 at 20, docs/TRAINING.md:117-126)
FIT_DIR = ROOT / "build" / "chip_smoke_fit"
FIT_EPOCHS = (12, 24)
FIT_RECIPE = ("--warm-up", "1", "2", "--schedule", "40", "50", "--device-geometry")
FIT_MIN_MAP = 0.15
FIT_LOSS_RATIO = 0.2
# cli/eval.py in its own process against the run's last logged mAP, at the
# gate that eval used: a fresh process may pick other cuDNN algorithms, and
# a detection at the gate can flip
FIT_EVAL_MAP_TOL = 2e-3
FIT_TOP_K = 512
# bf16 heads vs float32 on the trained weights, relative to the largest
# logit. BF16_REL_TOL (5e-2) was set on the init weights, which contract;
# trained, the network amplifies bf16's roundings: on the weights of two
# fits and the 32 test images the JAX package's own bf16 model errs by
# 0.051-0.081 against its float32 (XLA on the CPU), the port by
# 0.061-0.079 (CPU autocast and the card; tests/_torch_bf16_probe.py), so
# 5e-2 lies below the reference's own error. The fit is not deterministic
# on the card, and its error moves with the weights drawn (0.064-0.103 over
# five fits): so the card's error is held to the same quantity computed a
# second time, on the CPU through the plain path (CPU autocast bf16, as
# tests/_torch_bf16_probe.py runs it), on the same weights and batch:
# card <= FIT_BF16_VS_CPU x CPU. Four fits on an NVIDIA H100 80GB HBM3 read
# (card, CPU) (0.0916, 0.0892), (0.0602, 0.0613), (0.0615, 0.0629) and
# (0.0577, 0.0593): ratios 0.974-1.027. 1.25 lies as far above the largest
# ratio as the absolute 0.1 it replaces lay above the largest error
FIT_BF16_VS_CPU = 1.25
FIT_WORKERS = 4
FIT_DTYPES = {"f32": (False, None), "bf16": (False, torch.bfloat16),
              "folded_f32": (True, None), "folded_bf16": (True, torch.bfloat16)}
LOG_HEADER = "Epoch\tLoss\tPrecision\tTime\tIOU\tLearningRate"

# the mbv3 phase: MobileNetV3-YOLO and its MACC-lite graph at the VOC
# contract (seeded init, BatchNorm calibrated), served and stepped in this
# process, then MBv3-YOLO through the train, eval and infer CLIs on the
# data phase's shards with the fit recipe for MBV3_EPOCHS epochs; the loss
# bar set before the first run (the JAX package's MBv3 logged mAP 0.685 at
# epoch 20 of its recipe, docs/TRAINING.md §3d; printed here, not held)
MBV3_BACKBONES = ("mbv3", "mbv3_macc")
MBV3_DIR = ROOT / "build" / "chip_smoke_mbv3"
MBV3_EPOCHS = 3
MBV3_LOSS_RATIO = 0.5
MBV3_ITERS = 10
# images the MBv3 graphs' BatchNorm statistics are calibrated on: the SE
# modules' BNs see one pooled value an image, and from 4 images their
# variance is so far off that other inputs reach logits of ~30-160 (scores
# saturate at 1.0 and top-K's order among ties is each library's own);
# from 32 the heads stay near unit scale on any input
MBV3_CALIB = 32
MBV3_DTYPES = {"f32": (False, None), "bf16": (False, torch.bfloat16),
               "folded_f32": (True, None), "folded_bf16": (True, torch.bfloat16)}
# the pruned MBv3: the CLI's checkpoint cut by tools/prune.py, and
# MACC-lite's head site cut in this process; the cut's evals, its requests
# and the float64 slices at a gate low enough to keep detections of a
# 3-epoch model (at the run's own gate, 0.11, it keeps none: mAP 0)
MBV3_CUT = 0.3
MBV3_CUT_CONF = 0.01
# the float64 slices' gate lies in a gap of the CPU's scores at least this
# wide: far above the float32 decode's rounding (~1e-7 on scores in [0, 1])
SLICE_GAP = 1e-5
# the slim phase: Network Slimming with the port's train CLI (prox, the fit
# recipe), continuing the fit phase's plain run for SLIM_EPOCHS epochs; its
# tools/prune.py on the plain checkpoint and on the slim one, the cuts
# evaluated unfine-tuned, the 50% cut fine-tuned SLIM_FT_EPOCHS epochs from
# its params.npz and served folded in this process. Bars set before the
# first run: the slim run's bottom-30% |gamma| mass below SLIM_MASS_SHARE
# of the plain checkpoint's (JAX: 9.3% after 8 epochs against ~30%
# unslimmed, docs/TRAINING.md §7b-7c), and the 30% cut's mAP at least
# SLIM_CUT30_SHARE of its parent's. A slim run from scratch for 12 epochs
# (on an NVIDIA H100 80GB HBM3) met the first (6.4% against 29.7%) and not
# the second (the parent at mAP 0.250, the cut at 0.062): its gammas were
# still spread (median 0.136), so the cut took real mass; JAX's free cut
# came at 60 epochs (§7c)
# the dist phase: two gloo ranks on the one card (NCCL refuses two ranks
# on one device) and one NCCL rank at world size 1, as processes of their
# own; the data-parallel geometry steps at a global batch of 16 from the
# data phase's shards, kernel 6 thrice and kernel 5 once
DIST_DIR = ROOT / "build" / "chip_smoke_dist"
DIST_BATCH = 16
DIST_RANKS = 2
DIST_MODES = (True, True, True, "split")
DIST_SEED = 4321
DIST_TIMEOUT = 400
# JAX's tests/test_sharding.py:61-69: loss rtol 2e-4; parameters atol
# 2.5e-3 (two all-reduce orders can flip AdamW's first step on a near-zero
# gradient, one lr step); the BatchNorm statistics to the loss's rtol,
# relative to each statistic's largest value (at least 1, ``step_err``)
DIST_LOSS_RTOL = 2e-4
DIST_PARAM_ATOL = 2.5e-3
# the losses after the first update: tests/test_multiprocess.py's rtol
# 3e-3 across process layouts (a flipped first AdamW step moves the next
# loss, ~7e-4 there)
DIST_LATER_LOSS_RTOL = 3e-3
# the running statistics after the first step, on the scale of each
# layer's activations (``step_err``), to the loss's rtol: float32 with TF32
# off on both sides, they differ by the order of the sums (float64 over
# two ranks against cuDNN's float32 over one batch); statistics of one
# rank's rows alone, the fault this check is for, must lie above it, and
# the phase checks that they do
DIST_BN_TOL = 2e-4
# test_tensor_parallel_step_matches_dp: loss rtol 3e-4, parameters 2.5e-3
TP_LOSS_RTOL = 3e-4
TP_PARAM_ATOL = 2.5e-3
# each rank's half batch may take another cuDNN algorithm than the fit
# phase's one process: the mAP within 1e-3 of the fit phase's eval at the
# same precision (unfolded: its cli.eval, torch's defaults; folded: its
# in-process folded float32 eval, TF32 off), bit-equal across ranks
DIST_MAP_TOL = 1e-3
# the TP step with slim_mode loss: at 1e-4 over the ~8.4k prunable gammas
# (|gamma| ~1 at init) the penalty adds ~0.8 to the loss, so a penalty
# counted on a rank's slices alone, or twice, shows far past TP_LOSS_RTOL;
# each rank's penalty (its float32 sums) against the gathered model's in
# float64
DIST_SLIM_L1 = 1e-4
DIST_PENALTY_RTOL = 1e-6
SLIM_DIR = ROOT / "build" / "chip_smoke_slim"
SLIM_EPOCHS = 8
SLIM_FT_EPOCHS = 2
SLIM_L1 = "1e-4"
SLIM_CUTS = (0.3, 0.5)
SLIM_MASS_SHARE = 0.5
SLIM_CUT30_SHARE = 0.8
# folded against unfolded test mAP of the fine-tuned cut: one detection
# near the gate may flip with float32 rounding in another order
SLIM_FOLD_MAP_TOL = 1e-3
HEADS = ("out0", "out1")
# the bdd phase: the BDD100K multi-task path (detection and drivable-area
# segmentation). A fabricated BDD-style tree (tools/make_fabricated_bdd.py:
# per-image COCO JSON whose class map drops 2 of its 5 classes,
# single-channel seg PNGs of two tinted bands, and its own model yaml:
# 352x352, 3 classes, seg 2, the full-width MBv2-YOLO), built by the port's
# build_dataset CLI, trained by cli.train --device-geometry (the
# segmentation geometry step) and scored by cli.eval (mAP and seg mIoU),
# each its own process; the published BDD model (configs/bdd100k:
# 416x416, 7 classes, seg 2) served unfolded and folded in this process
BDD_DIR = ROOT / "build" / "chip_smoke_bdd"
BDD_TRAIN, BDD_TEST, BDD_SEED = 256, 64, 11
# the fit recipe at 4x its learning rate: at 7e-4 the seg head's outputs
# stay under the 0.5 gate for tens of epochs (the JAX package's run of this
# tree logged seg mIoU 0.00 at epoch 6, 0.01 at 20 and 0.32 at 40,
# docs/TRAINING.md §6b); at 2.8e-3 the card's first run logged 0.30 at
# epoch 10, 0.42 at 12 and 0.68 at 14. The loss bar set before the first
# run on the card
BDD_EPOCHS = 14
BDD_LR = "2.8e-3"
BDD_LOSS_RATIO = 0.2
# the step held card vs CPU: a loader batch at a bucket small enough for
# the CPU's float64 step
BDD_STEP_BATCH, BDD_STEP_SIZE = 4, 160
# the float64 evaluator, card vs CPU, on the first test images
BDD_EVAL_BATCH, BDD_EVAL_BATCHES = 4, 2
# the seg geometry step on BDD_STEP_BATCHES loader batches, held card vs
# CPU (float64) on the same inputs, the twin's images and seg maps, at
# BDD_STEP_RTOL (loss, seg_obj, seg_no_obj) on the reading BDD_STEP_GATE
# names: the card's float32 step. The path's step (float32 from the
# kernel's images, held to the twin's at AUG_MAX_ERR / AUG_MEAN_ERR) against
# the CPU read 5.1e-6 to 6.1e-4 over 8 runs, near the bar. On an NVIDIA H100
# 80GB HBM3 the images made that tail: from the twin's images the card's
# float32 step read <= 3.2e-7 over 5 batches, its float64 step <= 1.9e-7
# (the loss is float32 on both), while the kernel's images read 4.7e-5 to
# 2.2e-4 (their values up to one bf16 spacing apart; what in the loss
# amplifies that was not measured)
BDD_STEP_BATCHES = 5
BDD_STEP_GATE = "f32_twin"
BDD_STEP_RTOL = 1e-3
# the published model served at batch 32, 416x416 (its block shapes 208,
# 104, 52, 26 and 13 are the VOC model's 176-11 at another size)
BDD_SERVE_CONFIG = load_yaml(default_data_yaml("bdd100k/config.yaml"))
BDD_SERVE_BATCH = 32
BDD_SERVE_DTYPES = {"f32": (False, None), "bf16": (False, torch.bfloat16),
                    "folded_f32": (True, None), "folded_bf16": (True, torch.bfloat16)}
# the HPO sweep (hpo/random_search.py) as its own process on the bdd
# phase's data yaml: 2 trials of 2 epochs (one in-run eval each), seeded
HPO_DIR = ROOT / "build" / "chip_smoke_hpo"
HPO_TRIALS, HPO_EPOCHS, HPO_SEED = 2, 2, 5
# the quant phase: the fit phase's checkpoint through the port's quantize
# CLI (its own process): calibration on 4 test batches of 8, the float vs
# int8 mAP A/B at the checkpoint's gate; the artifact then served in this
# process through QuantSim (kernel 1 counted) and held card vs CPU
QUANT_DIR = ROOT / "build" / "chip_smoke_quant"
QUANT_BATCH = 8
QUANT_CALIB_BATCHES = 4
QUANT_IMAGES = 4
# the int8 simulation's sanity bar, and PERF.md's prediction of the drop
# (written before the first run)
QUANT_MAP_SHARE = 0.5
QUANT_PREDICTED_DROP = "0.00-0.04"
# QuantSim heads, card vs CPU in float64 on the same artifact, relative to
# the largest logit: float64 summation order, the grid snap in float32 on
# both (a float64 value a few ulp away rounds to the same float32 but with
# a chance of ~1e-8, and then must also sit on a grid boundary to flip)
QUANT_F64_REL_TOL = 1e-6
# the export phase: the port's export CLI (each its own process) writes the
# fit checkpoint as .pt2 programs at batch 8, 352x352, unfolded and folded;
# a fresh process loads each and serves the 64 test images; the npz export
# and the reference converter's round trip are served by cli/infer's loader
EXPORT_DIR = ROOT / "build" / "chip_smoke_export"
EXPORT_BATCH = 8
# loaded program vs the eager predict in this process, TF32 off on both: the
# same kernels and convolutions on the same inputs
EXPORT_DETS_TOL = 1e-5
EXPORT_ITERS = 20
EXPORT_PREDICTED = "loaded b8 within 15% of eager"
EXPORTED_OPS = {"unfolded": {"nms_suppress": 1},
                "folded": {"nms_suppress": 1, **FUSED_PER_REQUEST}}
# the fresh serving process: the kernels package (which registers the
# ops) and torch alone, as tools/export.py's last message says
SERVE_PT2 = """
import json, sys, time
import numpy as np
import torch
import mobilenet_yolo_tpu_torch.kernels as kernels
from mobilenet_yolo_tpu_torch.kernels import fused_block

args = json.loads(sys.argv[1])
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
counters = {"nms_suppress": kernels.suppress,
            "fused_stem_block0": fused_block.fused_stem_block0,
            "fused_inverted_residual_s2": fused_block.fused_inverted_residual_s2,
            "fused_inverted_residual": fused_block.fused_inverted_residual}
images = torch.from_numpy(np.load(args["images"])).cuda()
val_conf = torch.tensor(args["val_conf"], device="cuda")
b, report = args["batch"], {}
for name, path in args["programs"].items():
    t0 = time.perf_counter()
    program = torch.export.load(path).module()
    load_s = time.perf_counter() - t0
    for counter in counters.values():
        counter.launches = 0
    with torch.inference_mode():
        outs = [program(images[i:i + b], val_conf) for i in range(0, len(images), b)]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    np.savez(args["out"][name], dets=torch.cat([o[0] for o in outs]).cpu().numpy(),
             keep=torch.cat([o[1] for o in outs]).cpu().numpy())
    with torch.inference_mode():
        for _ in range(3):
            program(images[:b], val_conf)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args["iters"]):
            program(images[:b], val_conf)
        end.record()
        torch.cuda.synchronize()
    report[name] = {"load_s": load_s, "launches": launches,
                    "b8_ms": start.elapsed_time(end) / args["iters"]}
print(json.dumps(report))
"""
MASS_LINE = re.compile(r"hold ([0-9.]+)% of total \|gamma\| mass")


def report(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


# mean device time per call, CUDA events around the calls
cuda_ms = functools.partial(device_ms, device="cuda")


def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py drives the port on an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
           torch=torch.__version__, cuda=torch.version.cuda)
    return torch.device("cuda", 0), smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    seconds = time.perf_counter() - t0
    log = lib.with_suffix(".log").read_text()
    ptxas = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
    report("build", seconds=f"{seconds:.2f}", library=lib.name, ptxas=" | ".join(ptxas))
    # the tensor-core kernels' instances (blocks <S, MW, NW, warps>, the
    # stem <type, MW, NW>): registers, spills
    for source, symbol, key in (("fused_block_bf16.cu", "fused_block_bf16_kernelI", "bf16_kernel"),
                                ("fused_block.cu", "fused_block_f32_kernelI", "f32_kernel"),
                                ("fused_stem.cu", "fused_stem_kernelI", "stem_kernel")):
        instance = None
        for line in log.split(f"== {source}")[1].split("\n== ")[0].splitlines():
            if "Compiling entry function" in line:
                instance = line.split(symbol)[1].split("EEEv")[0].replace("13__nv_bfloat16", " bf16 ")
                instance = instance.replace("Li", " ").replace("E", " ").split()
                instance = "<" + ",".join("f32" if a == "f" else a for a in instance) + ">"
            elif "spill stores" in line:
                spill_bytes = int(line.split(",")[1].split()[0])
            elif "Used" in line and instance:
                report("build", **{key: instance}, registers=int(line.split("Used ")[1].split()[0]),
                       spill_store_bytes=spill_bytes)
                instance = None


def phase_kernel(device) -> int:
    chain = torch.zeros((1, 128, 128), device=device)
    chain[0, 0, 1] = chain[0, 1, 2] = 1.0
    chain_valid = torch.zeros((1, 128), device=device)
    chain_valid[0, :3] = 1.0
    cases = {"b128_k256": probe_nms.random_over(BATCH, 256, 0.05, device, seed=SEED),
             "b128_k60": probe_nms.random_over(BATCH, 60, 0.2, device, seed=SEED + 1),
             "chain": (chain, chain_valid),
             "b128_k256_full": probe_nms.random_over(BATCH, 256, 0.05, device, full=True,
                                                     seed=SEED + 2)}
    worst = 0
    for name, (over, valid) in cases.items():
        keep = suppress(over, valid)
        want = suppress_reference(over, valid)
        torch.cuda.synchronize()
        err = int((keep.int() - want.int()).abs().max())
        worst = max(worst, err)
        check(err == 0, f"kernel keep == reference keep ({name})")
        if name == "chain":
            keep = keep.cpu()
            check(keep[0, :3].tolist() == [True, False, True] and not keep[0, 3:].any(),
                  "chain case: a kept, b cut, c kept")
        report("kernel", case=name, kept=int(keep.sum()), max_abs_err=err)
    return worst


def head_logits(model, images_nhwc: torch.Tensor, dtype=None) -> dict[str, torch.Tensor]:
    with torch.inference_mode(), torch.autocast(images_nhwc.device.type, dtype=dtype,
                                                enabled=dtype is not None):
        return {k: v.float() for k, v in model(images_nhwc.permute(0, 3, 1, 2)).items()}


def check_logits(init_model: torch.nn.Module, images: torch.Tensor, device) -> None:
    """Card vs CPU float32 logits and card bf16 vs float32 logits, on the
    weights exactly as the seeded init built them. There the network
    contracts, so each comparison sees the rounding of a few layers; with
    calibrated statistics a random network amplifies rounding ~450-fold
    (float32 against float64 on the CPU: 2.7e-5), which would leave bf16
    nothing to be held to."""
    cpu_logits = head_logits(init_model.eval(), images)
    card_model = copy.deepcopy(init_model).to(device).to(memory_format=torch.channels_last)
    f32_logits = head_logits(card_model, images.to(device))
    bf16_logits = head_logits(card_model, images.to(device), torch.bfloat16)
    for key in ("out0", "out1"):
        err32 = rel_err(f32_logits[key], cpu_logits[key])
        err16 = rel_err(bf16_logits[key], f32_logits[key])
        check(err32 <= F32_REL_TOL, f"{key} card vs CPU f32 rel err {err32:.3g} <= {F32_REL_TOL}")
        check(err16 <= BF16_REL_TOL, f"{key} bf16 vs f32 rel err {err16:.3g} <= {BF16_REL_TOL}")
        report("logits", head=key, shape=tuple(f32_logits[key].shape),
               max_abs=f"{float(cpu_logits[key].abs().max()):.4g}",
               card_vs_cpu_f32_rel=f"{err32:.3g}", bf16_vs_f32_rel=f"{err16:.3g}",
               tf32=False)


def phase_serve(device) -> tuple[int, dict]:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    # built on the CPU: the phase holds the card against a CPU copy
    model = build_model(VOC_CONFIG, device="cpu", generator=torch.Generator().manual_seed(SEED))
    check_logits(model, torch.from_numpy(
        rng.normal(0.0, 1.0, (2, SIZE, SIZE, 3)).astype(np.float32)), device)
    calibrate_bn(model, torch.from_numpy(
        rng.normal(0.0, 1.0, (4, SIZE, SIZE, 3)).astype(np.float32)))
    cpu_model = copy.deepcopy(model)
    model.to(device)
    predict = {"f32": make_predict_fn(model, VOC_CONFIG),
               "u8": make_predict_fn(model, VOC_CONFIG, normalize=True),
               "bf16": make_predict_fn(model, VOC_CONFIG, dtype=torch.bfloat16)}

    gen = torch.Generator(device=device).manual_seed(SEED)
    x128 = torch.randn((BATCH, SIZE, SIZE, 3), generator=gen, device=device)
    x1 = x128[:1].clone()
    u8 = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=gen, device=device,
                       dtype=torch.uint8)
    val_conf = torch.tensor(VAL_CONF, device=device)
    requests = [("f32_b1", "f32", x1), ("f32_b128", "f32", x128),
                ("u8_b128", "u8", u8), ("bf16_b128", "bf16", x128)]

    # the main path: every request through make_predict_fn, launch count read around it
    suppress.launches = 0
    results = {name: predict[mode](images, val_conf) for name, mode, images in requests}
    torch.cuda.synchronize()
    launches = suppress.launches
    check(launches == len(requests), f"suppress kernel launched once per request ({launches})")
    report("serve", requests=len(requests), suppress_launches=launches)

    n_cand = ((SIZE // 32) ** 2 + (SIZE // 16) ** 2) * 3
    for name, mode, images in requests:
        dets, keep = results[name]
        b = images.shape[0]
        check(dets.shape == (b, min(256, n_cand), 7) and keep.shape == (b, min(256, n_cand)),
              f"{name} output shapes")
        check(bool(torch.isfinite(dets).all()), f"{name} detections finite")
        # rebuild the request's `over` from the candidates it returned
        over = _suppression_matrix(dets[..., :4], dets[..., 6].to(torch.int32), IOU)
        valid = (dets[..., 4] > val_conf).float()
        kernel_keep = suppress(over, valid)
        ref_keep = suppress_reference(over, valid)
        check(torch.equal(kernel_keep, ref_keep), f"{name}: kernel keep == reference keep")
        check(torch.equal(keep, ref_keep), f"{name}: served keep == reference keep")
        check(0 < int(keep.sum()) < int(valid.sum()), f"{name}: NMS kept some and cut some")
        report("serve", request=name, kept=int(keep.sum()), valid=int(valid.sum()),
               over_pairs=int(over.sum()), kernel_equals_reference=True)

    # the whole slice, card vs CPU, on the served weights in float64: the
    # calibrated network's amplified float32 rounding could reorder
    # near-equal scores, float64's cannot
    small = x128[:2].double()
    ref_card = copy.deepcopy(cpu_model).double().to(device)
    want_dets, want_keep = make_predict_fn(cpu_model.double(), VOC_CONFIG)(
        small.cpu(), val_conf.cpu())
    dets, keep = (t.cpu() for t in make_predict_fn(ref_card, VOC_CONFIG)(small, val_conf))
    check(torch.equal(keep, want_keep), "float64 slice keep, card == CPU")
    dets_err = float((dets[keep] - want_dets[keep]).abs().max())
    check(dets_err <= DETS_TOL, f"float64 slice kept detections, card vs CPU {dets_err:.3g}")
    report("reference", shape=tuple(small.shape), dtype="float64", kept=int(keep.sum()),
           keep_equal=True, dets_max_abs_err=f"{dets_err:.3g}")
    return launches, {"model": model, "predict": predict, "x128": x128, "x1": x1,
                      "u8": u8, "val_conf": val_conf}


def geometry_tensors(batch: dict, device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def slot_args(g: dict, seed: int) -> tuple:
    """The per-slot view of a geometry batch, as the split path feeds
    ``slot_aug``: (B*T, S, S, 3) slots and (B*T, ...) plans."""
    b, t, s = g["slots"].shape[:3]
    return (g["slots"].reshape(b * t, s, s, 3), seed,
            *(g[k].reshape(b * t, *g[k].shape[2:])
              for k in ("noise_gate", "noise_scale", "noise_per_channel", "jitter_op",
                        "jitter_factor")))


def compose_args(g: dict, seed: int) -> tuple:
    return (g["slots"], seed,
            *(g[k] for k in ("noise_gate", "noise_scale", "noise_per_channel", "jitter_op",
                             "jitter_factor", "src_rect", "dst_rect", "fill_rect",
                             "fill_color", "fill_from_mean", "flip", "active")))


def aug_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    d = (got.float() - want.float()).abs()
    worst, mean = float(d.max()), float(d.mean())
    check(worst <= AUG_MAX_ERR and mean < AUG_MEAN_ERR,
          f"{what}: max |kernel - twin| {worst} <= {AUG_MAX_ERR}, mean {mean:.3g} < {AUG_MEAN_ERR}")
    return worst


def phase_aug_kernels(device) -> tuple[dict, dict]:
    worst = {"slot_aug": 0.0, "aug_compose": 0.0}
    batches = {}
    for stage in TRAIN_SIZES:
        g = geometry_tensors(random_geometry_batch(np.random.default_rng(SEED + stage),
                                                   TRAIN_BATCH, stage), device)
        batches[stage] = g
        ops, facs = g["jitter_op"], g["jitter_factor"]
        hue = ops == 3
        report("aug_kernels", stage=stage, slots=int(g["active"].sum()),
               four_tile_images=int((g["active"].sum(1) == 4).sum()),
               mean_fills=int(g["fill_from_mean"].sum()), flips=int(g["flip"].sum()),
               noised=int(g["noise_gate"].sum()),
               hue_negative=int((hue & (facs < 0)).sum()),
               hue_positive=int((hue & (facs > 0)).sum()))
        check(bool((hue & (facs < 0)).any() and (hue & (facs > 0)).any()),
              "the batch holds both hue signs")
        tiles = g["active"].sum(1)
        check(bool((tiles == 1).any() and (tiles == 4).any() and g["noise_gate"].any()),
              "the batch holds 1-tile and 4-tile images and noised slots")
        args = slot_args(g, AUG_SEED)
        err = aug_err(slot_aug(*args), slot_aug_reference(*args, dtype=torch.bfloat16),
                      f"slot_aug S={stage}")
        worst["slot_aug"] = max(worst["slot_aug"], err)
        args = compose_args(g, AUG_SEED)
        err = aug_err(aug_compose(*args, (stage, stage)),
                      aug_compose_reference(*args, (stage, stage)), f"aug_compose S={stage}")
        worst["aug_compose"] = max(worst["aug_compose"], err)
        report("aug_kernels", stage=stage, slot_aug_max_abs_err=worst["slot_aug"],
               aug_compose_max_abs_err=worst["aug_compose"], tol=AUG_MAX_ERR)

    # the kernel's noise field alone: mid-grey slots, noise on, no program
    n, stage = TRAIN_BATCH * 4, TRAIN_SIZES[0]
    slots = torch.full((n, stage, stage, 3), 128, dtype=torch.uint8, device=device)
    plan = (torch.ones(n, dtype=torch.bool, device=device),
            torch.full((n,), NOISE_STD, device=device),
            torch.arange(n, device=device) % 3 == 0,   # per-channel draws on a third
            torch.full((n, 5), -1, dtype=torch.int32, device=device),
            torch.ones((n, 5), device=device))
    delta = slot_aug(slots, AUG_SEED, *plan, dtype=torch.float32) - 128.0
    mean, std = float(delta.mean()), float(delta.std())
    slot_mean = delta.mean(dim=(1, 2, 3)).abs().max().item()
    slot_std = (delta.std(dim=(1, 2, 3)) / NOISE_STD - 1.0).abs().max().item()
    check(abs(mean) < NOISE_BULK_MEAN_TOL, f"noise bulk mean {mean:.4g}")
    check(abs(std / NOISE_STD - 1.0) < NOISE_BULK_STD_REL, f"noise bulk std {std:.5g}")
    check(slot_mean < NOISE_SLOT_MEAN_TOL and slot_std < NOISE_SLOT_STD_REL,
          f"noise per slot: max |mean| {slot_mean:.4g}, max |std/scale - 1| {slot_std:.4g}")
    report("aug_kernels", noise_slots=n, bulk_mean=f"{mean:.5f}", bulk_std=f"{std:.5f}",
           scale=NOISE_STD, slot_max_abs_mean=f"{slot_mean:.4f}",
           slot_max_std_rel_err=f"{slot_std:.4f}")
    return worst, batches


def step_args(g: dict, seed: int) -> tuple:
    return (*(g[k] for k in GEOMETRY_BATCH_KEYS), g["gt"], g["n_gt"], seed)


def phase_train(device, batches: dict) -> tuple[dict, dict]:
    """The main training path: seeded full-width weights, a few geometry
    steps per aug mode and dtype, the kernels' launch counts read around
    them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    init = build_model(VOC_CONFIG, generator=torch.Generator().manual_seed(SEED))
    init = init.to(memory_format=torch.channels_last)
    size, large = TRAIN_SIZES
    g, g_large = batches[size], batches[large]
    watch = ("backbone.stem.conv.weight", "yolo_headS32.out.weight", "backbone.stem.bn.running_mean",
             "backbone.block16.project.bn.running_var")
    start = {k: v.detach().clone() for k, v in init.state_dict().items() if k in watch}
    check(len(start) == len(watch), f"watched tensors exist: {sorted(start)}")

    runs, losses_by_run, expected = {}, {}, {"slot_aug": 0, "aug_compose": 0}
    slot_aug.launches = aug_compose.launches = 0
    for dt_name, dtype in DTYPES.items():
        for mode_name, mode in MODES.items():
            model = copy.deepcopy(init)
            state = create_train_state(model)
            step = make_geometry_train_step(model, VOC_CONFIG, fused_aug=mode, dtype=dtype)
            losses = []
            for i in range(TRAIN_STEPS):
                state, metrics = step(state, *step_args(g, AUG_SEED + i), out_hw=(size, size))
                losses.append(metrics["loss"])
            n_steps = TRAIN_STEPS
            if mode_name == "full":
                state, metrics = step(state, *step_args(g_large, AUG_SEED), out_hw=(large, large))
                losses.append(metrics["loss"])
                n_steps += 1
            expected["aug_compose" if mode_name == "full" else "slot_aug"] += \
                n_steps if mode_name != "plain" else 0
            losses = [float(x) for x in losses]
            check(all(np.isfinite(losses)), f"{mode_name}/{dt_name} losses finite: {losses}")
            moved = {k: not torch.equal(v, model.state_dict()[k]) for k, v in start.items()}
            check(all(moved.values()), f"{mode_name}/{dt_name} params and BN stats moved: {moved}")
            report("train", mode=mode_name, dtype=dt_name, batch=TRAIN_BATCH,
                   steps=f"{TRAIN_STEPS}x{size}" + (f"+1x{large}" if mode_name == "full" else ""),
                   losses="/".join(f"{x:.5f}" for x in losses), moved=True)
            runs[(mode_name, dt_name)] = (step, state)
            losses_by_run[(mode_name, dt_name)] = losses
    torch.cuda.synchronize()
    launches = {"slot_aug": slot_aug.launches, "aug_compose": aug_compose.launches}
    check(launches == expected, f"kernel launches {launches} == steps of their modes {expected}")
    report("train", launches=launches, expected=expected)

    # the same weights, batch and seed through each mode: the kernels
    # against the plain ops, noise included (the card counterpart of the
    # JAX package's test_fused_step_matches_xla_step)
    first = {m: float(losses_by_run[(m, "f32")][0]) for m in MODES}
    rel = {m: abs(first[m] - first["plain"]) / abs(first["plain"]) for m in ("full", "split")}
    check(all(r <= AUG_MODE_LOSS_RTOL for r in rel.values()),
          f"first f32 losses {first}: rel to plain {rel} <= {AUG_MODE_LOSS_RTOL}")
    report("train", first_loss_full=f"{first['full']:.6f}", first_loss_split=f"{first['split']:.6f}",
           first_loss_plain=f"{first['plain']:.6f}", rel_full=f"{rel['full']:.3g}",
           rel_split=f"{rel['split']:.3g}", tol=AUG_MODE_LOSS_RTOL)
    return launches, runs


def fabricate_and_build(tool: str, root: Path, n_train: int, n_test: int,
                        seed: int) -> tuple[float, float]:
    """A fabricated tree under ``root`` (``tools/<tool>``) and its shards
    built by the port's ``build_dataset`` CLI, each its own process (CPU
    only). Returns their seconds."""
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / tool), "--root", str(root),
                           "--train", str(n_train), "--test", str(n_test), "--seed", str(seed)],
                          cwd=ROOT, capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT,
                          check=False)
    check(proc.returncode == 0, f"{tool} exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    fabricate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_module("mobilenet_yolo_tpu_torch.cli.build_dataset", "-d", str(root / "data.yaml"))
    return fabricate_s, time.perf_counter() - t0


def fabricate_voc() -> tuple[float, float]:
    return fabricate_and_build("make_fabricated_voc.py", DATA_DIR, DATA_TRAIN, DATA_TEST,
                               DATA_SEED)


def fabricate_bdd() -> tuple[float, float]:
    return fabricate_and_build("make_fabricated_bdd.py", BDD_DIR, BDD_TRAIN, BDD_TEST, BDD_SEED)


def build_voc_shards(smi: str, built=None) -> dict:
    """The VOC tree and its shards (``fabricate_voc``, or the future
    ``built`` of it); check that the native record store loaded and that
    every record's labels read back as the tree's XML gives them. Returns
    the data yaml."""
    from PIL import Image

    fabricate_s, build_s = built.result() if built else fabricate_voc()
    check(records.native_loaded(), f"the native record store loaded: {records.route()}")
    check(host_augment._try_cv2() is not None, "the decoder is cv2")
    data = load_yaml(str(DATA_DIR / "data.yaml"))
    classes_map = {k: v for v, k in enumerate(["background", *data["classes"]["map"]])}
    n_records, n_boxes, shard_bytes = 0, 0, 0
    for split, keep_difficult, n in (("trainval_dataset_path", False, DATA_TRAIN),
                                     ("test_dataset_path", True, DATA_TEST)):
        shard = data[split]["lmdb"]
        reader = records.RecordReader(shard)
        check(len(reader) == n, f"{split}: {len(reader)} records, {n} written")
        names = Path(data[split]["lists"][0]).read_text().split()
        for i, name in enumerate(names):
            rec = reader[i]
            w, h = Image.open(io.BytesIO(rec.image_bytes)).size  # the JPEG's header
            want = to_yolo_labels(*parse_voc_xml(str(DATA_DIR / "Annotations" / f"{name}.xml"),
                                                 classes_map), w, h, keep_difficult)
            check(np.array_equal(rec.labels, want), f"{split} record {i} ({name}) labels")
            n_boxes += len(want)
        n_records += n
        shard_bytes += sum(f.stat().st_size for f in Path(shard).iterdir())
    report("data", what="build", fabricate_s=f"{fabricate_s:.2f}", build_dataset_s=f"{build_s:.2f}",
           records=n_records, boxes=n_boxes, shard_mb=f"{shard_bytes / 1e6:.2f}",
           labels_read_back=True, records_route=records.route(), decoder="cv2",
           card=f"'{smi}'")
    return data


class FirstRecords:
    """The first ``n`` records of a record reader, as a reader."""

    def __init__(self, reader, n: int):
        self.reader, self.n = reader, min(n, len(reader))

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int):
        if not 0 <= index < self.n:
            raise IndexError(index)
        return self.reader[index]


def voc_loader(shard: str, mode: str, sizes=None, prefetch: int = DATA_PREFETCH,
               n_records: int | None = None) -> Loader:
    """The VOC training loader over ``shard`` (its first ``n_records``
    records, if given) in one of ``LOADER_MODES``."""
    ds_kw, loader_kw = LOADER_MODES[mode]
    reader = records.RecordReader(shard)
    if n_records is not None:
        reader = FirstRecords(reader, n_records)
    ds = DetectionDataset(reader, phase="train", expand_scale=VOC_CONFIG["expand_scale"],
                          **ds_kw)
    norm = VOC_CONFIG["normalize"]
    return Loader(ds, TRAIN_BATCH, sizes or VOC_CONFIG["train_img_size"], norm["mean"],
                  norm["std"], mosaic_num=VOC_CONFIG["mosaic_num"], seed=SEED, prefetch=prefetch,
                  **loader_kw)


def data_step(model, mode: str, fused, dtype):
    """The train step a loader mode feeds: the plain step on host float32
    images, the plain step normalising uint8 and running the photometric
    programs on the card, or the geometry step in ``fused`` mode."""
    if mode == "geometry":
        return make_geometry_train_step(model, VOC_CONFIG, fused_aug=fused, dtype=dtype)
    u8 = mode == "u8"
    return make_train_step(model, VOC_CONFIG, normalize=u8, pixel_aug=u8, dtype=dtype)


def call_step(step, state, mode: str, t: dict, seed: int, out_hw):
    if mode == "host":
        return step(state, t["images"], t["gt"], t["n_gt"])
    if mode == "u8":
        return step(state, t["images"], t["gt"], t["n_gt"], t["jitter_op"], t["jitter_factor"])
    return step(state, *(t[k] for k in GEOMETRY_BATCH_KEYS), t["gt"], t["n_gt"], seed,
                out_hw=out_hw)


def resident_batch(mode: str, device, size: int = SIZE) -> dict:
    """A batch at ``size`` already on the card, in ``mode``'s form: random
    normalised images, random uint8 images with programs, or
    ``random_geometry_batch``."""
    rng = np.random.default_rng(SEED + 11)
    geom = random_geometry_batch(rng, TRAIN_BATCH, size)
    if mode == "geometry":
        return geometry_tensors(geom, device)
    batch = {"gt": geom["gt"], "n_gt": geom["n_gt"]}
    if mode == "host":
        batch["images"] = rng.normal(0.0, 1.0, (TRAIN_BATCH, size, size, 3)).astype(np.float32)
    else:
        batch["images"] = rng.integers(0, 256, (TRAIN_BATCH, size, size, 3), dtype=np.uint8)
        programs = [random_program(rng) for _ in range(TRAIN_BATCH)]
        batch["jitter_op"] = np.stack([p[0] for p in programs])
        batch["jitter_factor"] = np.stack([p[1] for p in programs])
    return geometry_tensors(batch, device)


def card_busy_ms(prof) -> float:
    """Milliseconds in which the card ran a kernel or a copy during a
    ``torch.profiler`` run: the union of its CUDA activity intervals, read
    from the raw trace (``key_averages`` would build an event object for
    each of the ~2,300 launches a step)."""
    spans = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy, reach = 0, 0
    for start, end in spans:
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy / 1e6


def timed_steps(batches, step, state, mode: str) -> dict:
    """Run the step on each batch of ``batches`` (loader batches, copied to
    the card as they come, or batches on the card) under ``torch.profiler``
    (CUDA activity only): CUDA events around each step, the host clock
    around the whole run, which ends in a synchronize.

    Two idle shares of the wall time: ``idle_share``, the card's, outside
    every kernel and copy the profiler saw (waiting for the loader, and the
    host's launches within and between steps); ``between_steps_idle``,
    outside every step's events (waiting for the loader and the copy)."""
    events, losses, out_hws = [], [], []
    cuda_activity = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=cuda_activity) as prof:
        t0 = time.perf_counter()
        for i, (batch, out_hw) in enumerate(batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = call_step(step, state, mode, batch, AUG_SEED + i, out_hw)
            end.record()
            events.append((start, end))
            losses.append(metrics["loss"])
            out_hws.append(out_hw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps_ms = sum(a.elapsed_time(b) for a, b in events)
    device_busy_ms = card_busy_ms(prof)
    check(0 < device_busy_ms <= wall_ms, f"{mode}: the profiler saw {device_busy_ms:.1f} ms "
                                         f"of the card's work in {wall_ms:.1f} ms")
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"{mode} losses finite: {losses}")
    return {"steps": len(events), "wall_ms": wall_ms, "step_ms": steps_ms / len(events),
            "img_per_s": len(events) * TRAIN_BATCH * 1e3 / wall_ms,
            "device_busy_ms": device_busy_ms, "idle_share": 1.0 - device_busy_ms / wall_ms,
            "between_steps_idle": 1.0 - steps_ms / wall_ms, "losses": losses,
            "sizes": sorted({hw[0] for hw in out_hws})}


def loader_feed(loader: Loader, device):
    """(batch on the card, out_hw) per loader batch, copied through
    ``batch_to_device`` (a fresh pinned copy, so the ring may refill the
    loader's buffer at once)."""
    for batch in loader:
        out_hw = batch.get("out_size") or batch["images"].shape[1:3]
        yield batch_to_device(batch, device), tuple(int(x) for x in out_hw)


def phase_data(device, smi: str, built=None) -> dict:
    """The input pipeline from JPEG shards into the training steps on the
    card: the loader alone in each mode, then feeding its step (the
    geometry step in both kernel modes, float32 and bf16), each beside the
    same step on a batch resident on the card; then the two augmentation
    kernels against their twins on a loader batch at each VOC bucket, with
    stale bytes in the inactive slots."""
    t_phase = time.perf_counter()
    data = build_voc_shards(smi, built)
    shard = data["trainval_dataset_path"]["lmdb"]

    for mode in LOADER_MODES:
        t0 = time.perf_counter()
        n, sources = 0, 0
        for batch in voc_loader(shard, mode):
            n += 1
            sources += batch["count"]
        dt = time.perf_counter() - t0
        report("data", what=f"loader_{mode}", batches=n, seconds=f"{dt:.3f}",
               batches_per_s=f"{n / dt:.3f}", img_per_s=f"{n * TRAIN_BATCH / dt:.1f}",
               source_img_per_s=f"{sources / dt:.1f}", prefetch=DATA_PREFETCH,
               card=f"'{smi}'")

    init = build_model(VOC_CONFIG, generator=torch.Generator().manual_seed(SEED))
    init = init.to(memory_format=torch.channels_last)
    watch = ("backbone.stem.conv.weight", "backbone.stem.bn.running_mean")
    start = {k: v.detach().clone() for k, v in init.state_dict().items() if k in watch}
    runs = {}
    for name, (mode, fused, dtype) in FED_MODES.items():
        model = copy.deepcopy(init)
        state, step = create_train_state(model), data_step(model, mode, fused, dtype)
        # a warmup step at every bucket, so that no first-shape cost lands
        # in the loader-fed epoch
        for size in TRAIN_BUCKETS:
            call_step(step, state, mode, resident_batch(mode, device, size), AUG_SEED,
                      (size, size))
        resident = [(resident_batch(mode, device), (SIZE, SIZE))]
        runs[name] = (model, state, step,
                      timed_steps(resident * DATA_REFERENCE_STEPS, step, state, mode))

    # the loader path: each mode's step fed one epoch, the kernels' counts
    # read around the whole of it
    slot_aug.launches = aug_compose.launches = 0
    expected = {"slot_aug": 0, "aug_compose": 0}
    for name, (mode, fused, dtype) in FED_MODES.items():
        model, state, step, ref = runs[name]
        before = (slot_aug.launches, aug_compose.launches)
        fed = timed_steps(loader_feed(voc_loader(shard, mode, n_records=DATA_FED_RECORDS),
                                      device), step, state, mode)
        torch.cuda.synchronize()
        launched = (slot_aug.launches - before[0], aug_compose.launches - before[1])
        want = (fed["steps"] if fused == "split" else 0, fed["steps"] if fused is True else 0)
        check(launched == want, f"{name}: kernel launches (slot_aug, aug_compose) {launched} "
                                f"== one per step of its mode {want}")
        expected["slot_aug"] += want[0]
        expected["aug_compose"] += want[1]
        moved = {k: not torch.equal(v, model.state_dict()[k]) for k, v in start.items()}
        check(all(moved.values()), f"{name} params and BN stats moved: {moved}")
        report("data", what=f"fed_{name}", steps=fed["steps"], buckets=fed["sizes"],
               step_ms=f"{fed['step_ms']:.3f}", img_per_s=f"{fed['img_per_s']:.1f}",
               idle_share=f"{fed['idle_share']:.4f}",
               between_steps_idle=f"{fed['between_steps_idle']:.4f}",
               device_busy_ms_per_step=f"{fed['device_busy_ms'] / fed['steps']:.3f}",
               resident_step_ms=f"{ref['step_ms']:.3f}",
               resident_img_per_s=f"{ref['img_per_s']:.1f}",
               resident_idle_share=f"{ref['idle_share']:.4f}",
               resident_between_steps_idle=f"{ref['between_steps_idle']:.4f}",
               resident_device_busy_ms_per_step=f"{ref['device_busy_ms'] / ref['steps']:.3f}",
               resident_size=SIZE,
               losses="/".join(f"{x:.4f}" for x in fed["losses"][:3]) + "/...",
               launches=launched, card=f"'{smi}'")
    torch.cuda.synchronize()
    launches = {"slot_aug": slot_aug.launches, "aug_compose": aug_compose.launches}
    check(launches == expected and min(launches.values()) > 0,
          f"loader-path kernel launches {launches} == steps of their modes {expected}")
    report("data", loader_launches=launches)

    # both kernels on a loader batch at every bucket, against their twins;
    # then the inactive slots, zero above, hold 0xFF: no active output may move
    worst = {"slot_aug": 0.0, "aug_compose": 0.0}
    buckets = {"slot_aug": {}, "aug_compose": {}}
    for size in TRAIN_BUCKETS:
        batch = next(iter(voc_loader(shard, "geometry", sizes=[[size, size]], prefetch=0)))
        active = batch["active"]
        check(batch["slots"].shape[2] == size and not active.all() and active.any(1).all(),
              f"S={size}: staged at the bucket, inactive slots present")
        batch["slots"][~active] = 0
        g = batch_to_device(batch, device)
        stale = dict(g, slots=g["slots"].clone())
        stale["slots"][~g["active"]] = 0xFF
        args, stale_args = slot_args(g, AUG_SEED), slot_args(stale, AUG_SEED)
        out = slot_aug(*args)
        err = aug_err(out, slot_aug_reference(*args, dtype=torch.bfloat16),
                      f"slot_aug on a loader batch, S={size}")
        worst["slot_aug"] = max(worst["slot_aug"], err)
        b, t = active.shape
        check(torch.equal(slot_aug(*stale_args).view(b, t, 3, size, size)[g["active"]],
                          out.view(b, t, 3, size, size)[g["active"]]),
              f"slot_aug S={size}: active slots unmoved by 0xFF in the inactive ones")
        cargs, stale_cargs = compose_args(g, AUG_SEED), compose_args(stale, AUG_SEED)
        out = aug_compose(*cargs, (size, size))
        err = aug_err(out, aug_compose_reference(*cargs, (size, size)),
                      f"aug_compose on a loader batch, S={size}")
        worst["aug_compose"] = max(worst["aug_compose"], err)
        check(torch.equal(aug_compose(*stale_cargs, (size, size)), out),
              f"aug_compose S={size}: images unmoved by 0xFF in the inactive slots")
        # times at this bucket on the loader batch, beside the twin and the bound
        n_slots = b * t
        slot_t = {"ms": cuda_ms(lambda: slot_aug(*args), iters=20),
                  "plain_ms": cuda_ms(lambda: slot_aug_reference(*args, dtype=torch.bfloat16),
                                      iters=2, warmup=1)}
        slot_t["bound_ms"] = bound_ms(0, n_slots * size * size * 3 * (1 + 2))[0]
        comp_t = {"ms": cuda_ms(lambda: aug_compose(*cargs, (size, size)), iters=20),
                  "plain_ms": cuda_ms(lambda: aug_compose_reference(*cargs, (size, size)),
                                      iters=2, warmup=1)}
        comp_t["bound_ms"] = bound_ms(0, int(active.sum()) * size * size * 3
                                      + b * size * size * 3 * 2)[0]
        buckets["slot_aug"][size], buckets["aug_compose"][size] = slot_t, comp_t
        report("data", what=f"kernels_s{size}", slots=int(active.sum()), of_slots=n_slots,
               four_tile_images=int((active.sum(1) == 4).sum()),
               noised=int(batch["noise_gate"].sum()),
               slot_aug_max_abs_err=worst["slot_aug"],
               aug_compose_max_abs_err=worst["aug_compose"], stale_bytes_unmoved=True,
               slot_aug_ms=f"{slot_t['ms']:.4f}", slot_aug_plain_ms=f"{slot_t['plain_ms']:.4f}",
               slot_aug_bound_ms=f"{slot_t['bound_ms']:.4f}",
               aug_compose_ms=f"{comp_t['ms']:.4f}",
               aug_compose_plain_ms=f"{comp_t['plain_ms']:.4f}",
               aug_compose_bound_ms=f"{comp_t['bound_ms']:.4f}", card=f"'{smi}'")
    report("data", phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=f"'{smi}'")
    return {name: {"loader_launches": launches[name],
                   "loader_max_abs_err": worst[name],
                   "loader_buckets": buckets[name]} for name in launches}


def fit_loaders(cfg: dict, data: dict, workers: int = 0) -> tuple[Loader, Loader]:
    """The train CLI's geometry-mode loaders over the data phase's shards:
    the training ``Loader`` (or ``WorkerLoader`` with ``workers``) and the
    uint8 eval loader."""
    train_ds = DetectionDataset(records.RecordReader(data["trainval_dataset_path"]["lmdb"]),
                                phase="train", expand_scale=cfg["expand_scale"],
                                apply_photometric=False)
    norm = cfg["normalize"]
    kw = {"num_workers": workers} if workers else {}
    train = (WorkerLoader if workers else Loader)(
        train_ds, cfg["batch_size"], cfg["train_img_size"], norm["mean"], norm["std"],
        mosaic_num=cfg["mosaic_num"], output_uint8=True, device_geometry=True,
        prefetch=DATA_PREFETCH, **kw)
    test = Loader(DetectionDataset(records.RecordReader(data["test_dataset_path"]["lmdb"]),
                                   phase="test"),
                  cfg["batch_size"], [[cfg["img_w"], cfg["img_h"]]], norm["mean"], norm["std"],
                  shuffle=False, pad_final=False, output_uint8=True)
    return train, test


def planned_steps(loader: Loader, epochs: int) -> list[int]:
    """Batches a loader plans for each training epoch (``Trainer.train_epoch``
    sets epoch e, and iterating plans epoch e + 1's shuffle and groups)."""
    counts = []
    for e in range(epochs):
        loader.epoch = e + 1
        counts.append(len(loader._sharded_plan()[0]))
    return counts


def fit_cli(data_yaml: str, smi: str) -> tuple[np.ndarray, str]:
    """The port's train CLI as a user runs it, in its own process from
    ``FIT_DIR`` (its TensorBoard events land there): ``FIT_EPOCHS[0]``
    epochs, then again to ``FIT_EPOCHS[1]``, which resumes. Returns the
    ``log.txt`` rows and the second run's output."""
    outs = []
    for epochs in FIT_EPOCHS:
        t0 = time.perf_counter()
        outs.append(run_module("mobilenet_yolo_tpu_torch.cli.train", "-y", data_yaml, "-c",
                               str(FIT_DIR), "--epochs", str(epochs), *FIT_RECIPE, cwd=FIT_DIR))
        report("fit", what="cli_train", epochs=epochs, seconds=f"{time.perf_counter() - t0:.1f}",
               line=outs[-1].strip().splitlines()[-1], card=f"'{smi}'")
    check("resumed" not in outs[0], "the first fit starts fresh")
    check(f"resumed from epoch {FIT_EPOCHS[0]}" in outs[1],
          f"the second fit resumed from epoch {FIT_EPOCHS[0]}:\n{outs[1][:2000]}")
    rows = read_log(FIT_DIR, FIT_EPOCHS[-1])
    events = list((FIT_DIR / "tensorboard").glob("events.out.tfevents.*"))
    check(len(events) == len(FIT_EPOCHS) and all(e.stat().st_size > 0 for e in events),
          f"each fit wrote its TensorBoard events under {FIT_DIR}: {events}")
    return rows, outs[1]


def phase_fit(device, smi: str, settle=None) -> dict:
    """Train the full-width MBv2-YOLO with the port's train CLI from the data
    phase's JPEG shards to a real mAP, resume it, serve the checkpoint
    through the eval and infer CLIs, then, in this process, evaluate the
    trained weights in float32, bf16 and folded (kernels 1-4) and time one
    ``Trainer.train_epoch`` fed by ``Loader`` against ``WorkerLoader``
    (kernel 6). ``settle`` (if given) is called before the in-process part,
    so that the card and the host are this process's again. Returns the
    kernels' launches in this process and the eval CLI's result at the
    checkpoint's own gate, with this process's folded float32 mAP at that
    gate (``folded_f32_mAP``)."""
    t_phase = time.perf_counter()
    shutil.rmtree(FIT_DIR, ignore_errors=True)
    FIT_DIR.mkdir(parents=True)
    data_yaml = str(DATA_DIR / "data.yaml")
    data, cfg = load_yaml(data_yaml), load_config(data_yaml)
    mc = cfg.model

    # 1-2: the CLI trains, resumes and learns
    rows, resumed_out = fit_cli(data_yaml, smi)
    losses, maps = rows[:, 1], rows[:, 2]
    raw = CheckpointManager(str(FIT_DIR)).restore_latest_raw()
    check(raw is not None and raw["epoch"] == FIT_EPOCHS[-1],
          f"the last checkpoint is epoch {FIT_EPOCHS[-1]}")
    plan = planned_steps(fit_loaders(mc, data)[0], FIT_EPOCHS[-1])
    steps = {int(st["step"]) for st in raw["optimizer"]["state"].values()}
    check(steps == {sum(plan)}, f"optimizer steps {steps} == planned {sum(plan)} ({plan})")
    ratio = losses[-1] / losses[0]
    report("fit", what="learned", loss_first=f"{losses[0]:.6f}", loss_last=f"{losses[-1]:.6f}",
           loss_ratio=f"{ratio:.4f}", bar_ratio=FIT_LOSS_RATIO,
           mAP_by_epoch="/".join(f"{m:.4f}" for m in maps[1::2]), last_mAP=f"{maps[-1]:.6f}",
           bar_mAP=FIT_MIN_MAP, steps=sum(plan), steps_per_epoch=plan[0],
           lr_last=rows[-1, 5], card=f"'{smi}'")
    check(ratio <= FIT_LOSS_RATIO,
          f"loss of epoch {FIT_EPOCHS[-1]} / epoch 1 = {ratio:.4f} <= {FIT_LOSS_RATIO}")
    check(maps[-1] >= FIT_MIN_MAP, f"last logged mAP {maps[-1]:.4f} >= {FIT_MIN_MAP}")

    # 3: the eval CLI at the gate the last in-run eval used, then at the
    # checkpoint's own; the infer CLI on one test image
    gates = re.findall(r"val_conf -> ([0-9.]+); mAP ([0-9.]+)", resumed_out)
    check(len(gates) >= 2, f"the resumed fit printed its evals: {gates}")
    gate = gates[-2][0]
    first = Path(data["test_dataset_path"]["lists"][0]).read_text().split()[0]
    image = DATA_DIR / "JPEGImages" / f"{first}.jpg"
    evals = ("mobilenet_yolo_tpu_torch.cli.eval", "-y", data_yaml, "-c", str(FIT_DIR),
             "--batch-size", str(mc["batch_size"]))
    at_gate, own, out = run_modules(
        (*evals, "--val-conf", gate), evals,
        ("mobilenet_yolo_tpu_torch.cli.infer", "-y", data_yaml, "-c", str(FIT_DIR), "-i",
         str(image), "--out-dir", str(FIT_DIR / "infer")))
    at_gate, own = json.loads(at_gate), json.loads(own)
    err = abs(at_gate["mAP"] - maps[-1])
    report("fit", what="cli_eval", gate=gate, mAP=f"{at_gate['mAP']:.6f}",
           log_mAP=f"{maps[-1]:.6f}", abs_err=f"{err:.3g}", tol=FIT_EVAL_MAP_TOL,
           margin=f"{FIT_EVAL_MAP_TOL - err:.3g}", own_val_conf=own["val_conf"],
           own_mAP=f"{own['mAP']:.6f}", card=f"'{smi}'")
    check(err <= FIT_EVAL_MAP_TOL, f"cli/eval mAP {at_gate['mAP']} vs log {maps[-1]}")
    check(own["val_conf"] == raw["val_conf"], "cli/eval restored the run's val_conf")
    check((FIT_DIR / "infer" / f"{image.stem}_result.jpg").is_file(),
          "cli/infer served the checkpoint and wrote its result")
    report("fit", what="cli_infer", image=image.name, line=out.strip().splitlines()[1],
           card=f"'{smi}'")

    if settle is not None:
        settle()
    # 4: the trained weights in this process: test mAP per dtype, unfolded
    # and folded, at the checkpoint's gate, TF32 off; the kernels' launches
    # from here on
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for counted in LAUNCH_COUNTERS:
        counted.launches = 0
    model = build_model(mc, device=device)
    model.load_state_dict(served_state_dict(raw))
    # the served weights alone, for off-card probes (tests/_torch_bf16_probe.py)
    torch.save(served_state_dict(raw), FIT_DIR / "served_weights.pt")
    test = Loader(DetectionDataset(records.RecordReader(data["test_dataset_path"]["lmdb"]),
                                   phase="test"), mc["batch_size"], [[mc["img_w"], mc["img_h"]]],
                  mc["normalize"]["mean"], mc["normalize"]["std"], shuffle=False,
                  pad_final=False)
    n_eval = -(-DATA_TEST // mc["batch_size"])
    folded = fold_batchnorm(model)
    maps_by = {}
    for name, (fold, dtype) in FIT_DTYPES.items():
        before = {k: c.launches for k, c in (("nms_suppress", suppress), *FUSED.items())}
        res = evaluate_detection(make_predict_fn(folded if fold else model, mc, top_k=FIT_TOP_K,
                                                 dtype=dtype),
                                 test, cfg.classes, float(raw["val_conf"]),
                                 batch_size=mc["batch_size"], device=device)
        torch.cuda.synchronize()
        maps_by[name] = res["mAP"]
        check(suppress.launches - before["nms_suppress"] == n_eval,
              f"{name}: suppress once per eval batch")
        for kernel, fn in FUSED.items():
            want = n_eval * FUSED_PER_REQUEST[kernel] if fold else 0
            check(fn.launches - before[kernel] == want, f"{name}: {kernel} launched {want}")
    batch = next(iter(test))
    x = torch.from_numpy(batch["images"]).to(device)
    heads = {name: head_logits(folded if fold else model, x, dtype)
             for name, (fold, dtype) in FIT_DTYPES.items()}
    bf16_err = max(rel_err(heads["bf16"][k], heads["f32"][k]) for k in HEADS)
    folded_bf16_err = max(rel_err(heads["folded_bf16"][k], heads["folded_f32"][k])
                          for k in HEADS)
    # the same error on the CPU, through the plain path, on the saved
    # served weights and the same batch
    t0 = time.perf_counter()
    cpu_model = build_model(mc, device="cpu").eval()
    cpu_model.load_state_dict(torch.load(FIT_DIR / "served_weights.pt", weights_only=True))
    x_cpu = torch.from_numpy(batch["images"])
    cpu_heads = {name: head_logits(cpu_model, x_cpu, dtype)
                 for name, dtype in (("f32", None), ("bf16", torch.bfloat16))}
    cpu_bf16_err = max(rel_err(cpu_heads["bf16"][k], cpu_heads["f32"][k]) for k in HEADS)
    ratio = bf16_err / cpu_bf16_err
    report("fit", what="trained_weights", val_conf=raw["val_conf"],
           **{f"mAP_{k}": f"{v:.6f}" for k, v in maps_by.items()},
           bf16_vs_f32_rel=bf16_err, cpu_bf16_vs_f32_rel=cpu_bf16_err,
           card_over_cpu=f"{ratio:.4f}", bar=FIT_BF16_VS_CPU, images=x.shape[0],
           cpu_seconds=f"{time.perf_counter() - t0:.1f}",
           folded_bf16_vs_folded_f32_rel=folded_bf16_err, card=f"'{smi}'")
    check(bf16_err <= FIT_BF16_VS_CPU * cpu_bf16_err,
          f"trained bf16 heads vs float32: card {bf16_err} <= {FIT_BF16_VS_CPU} x CPU "
          f"{cpu_bf16_err}")

    # 5: one epoch fed by the prefetching Loader against WorkerLoader's
    # processes, each warm at every bucket first; the card's idle share
    trainer = Trainer(copy.deepcopy(model), mc, cfg.classes,
                      TrainerConfig(checkpoint_dir=str(FIT_DIR / "in_process"),
                                    nms_top_k=FIT_TOP_K),
                      verbose=False, device_normalize=True, device_geometry=True, device=device)
    for name, workers in (("loader", 0), ("workers", FIT_WORKERS)):
        fed_epoch("fit", name, trainer, mc, data, workers, FIT_EPOCHS[-1], device, smi)
    before = suppress.launches
    _, test_u8 = fit_loaders(mc, data)
    trainer.evaluate(test_u8)
    torch.cuda.synchronize()
    check(suppress.launches - before == n_eval, "Trainer.evaluate: suppress once per eval batch")
    launches = {name: c.launches for name, c in (("nms_suppress", suppress),
                                                 ("aug_compose", aug_compose), *FUSED.items())}
    check(min(launches.values()) > 0, f"every kernel of the fit path launched: {launches}")
    report("fit", fit_launches=launches, phase_seconds=f"{time.perf_counter() - t_phase:.1f}",
           card=f"'{smi}'")
    return launches, dict(own, folded_f32_mAP=maps_by["folded_f32"])


def fed_epoch(phase: str, name: str, trainer: Trainer, mc: dict, data: dict, workers: int,
              epoch: int, device, smi: str) -> int:
    """One ``Trainer.train_epoch`` fed by ``Loader`` (or ``WorkerLoader``
    with ``workers``), warm at every bucket first, under ``torch.profiler``
    (img/s, epoch seconds, the card's idle share); ``aug_compose`` must
    launch once a step. Returns its launches."""
    train, _ = fit_loaders(mc, data, workers)
    for size in TRAIN_BUCKETS:
        warm = random_geometry_batch(np.random.default_rng(SEED + 12), mc["batch_size"], size,
                                     num_classes=mc["yolo"]["num_classes"])
        call_step(trainer.train_step, trainer.state, "geometry",
                  geometry_tensors(warm, device), AUG_SEED, (size, size))
    torch.cuda.synchronize()
    before = aug_compose.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = trainer.train_epoch(train, epoch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = aug_compose.launches - before
    check(n == planned_steps(fit_loaders(mc, data)[0], epoch + 1)[-1],
          f"{phase} {name}: aug_compose once per step ({n})")
    check(np.isfinite(stats["loss"]), f"{phase} {name}: epoch loss {stats['loss']}")
    idle = 1.0 - card_busy_ms(prof) / (wall * 1e3)
    report(phase, what=f"epoch_{name}", workers=workers, steps=n,
           img_per_s=f"{n * mc['batch_size'] / wall:.1f}", epoch_s=f"{wall:.3f}",
           idle_share=f"{idle:.4f}", loss=f"{stats['loss']:.6f}", prefetch=DATA_PREFETCH,
           card=f"'{smi}'")
    return n


def read_log(directory: Path, epochs: int, first: int = 1) -> np.ndarray:
    """A fit's ``log.txt`` rows (epoch, loss, mAP, time, IOU, rate) for
    epochs ``first``..``epochs``, checked whole and finite."""
    header, *lines = (directory / "log.txt").read_text().strip().splitlines()
    rows = np.asarray([[float(v) for v in line.split("\t")] for line in lines])
    n = epochs - first + 1
    check(header == LOG_HEADER and rows.shape == (n, 6)
          and rows[:, 0].tolist() == list(range(first, epochs + 1)),
          f"{directory}/log.txt holds its header and epochs {first}-{epochs}: {header!r}, "
          f"{rows.shape}")
    check(np.isfinite(rows).all(), f"{directory}/log.txt values finite: {rows[:, 1]}")
    return rows


def cli_fit(phase: str, what: str, data_yaml: str, ckpt: Path, epochs: int, *extra: str,
            smi: str, first: int = 1) -> tuple[np.ndarray, str]:
    """The port's train CLI as its own process from ``ckpt``'s parent
    (TensorBoard events land there) with the fit recipe, to epoch
    ``epochs`` from epoch ``first`` (after a ``--resume``); returns its log
    and its output."""
    t0 = time.perf_counter()
    out = run_module("mobilenet_yolo_tpu_torch.cli.train", "-y", data_yaml, "-c", str(ckpt),
                     "--epochs", str(epochs), *FIT_RECIPE, *extra, cwd=ckpt.parent)
    rows = read_log(ckpt, epochs, first)
    report(phase, what=what, epochs=epochs, seconds=f"{time.perf_counter() - t0:.1f}",
           loss_first=f"{rows[0, 1]:.6f}", loss_last=f"{rows[-1, 1]:.6f}",
           loss_ratio=f"{rows[-1, 1] / rows[0, 1]:.4f}",
           mAP_by_epoch="/".join(f"{m:.4f}" for m in rows[:, 2]),
           line=out.strip().splitlines()[-1], card=f"'{smi}'")
    return rows, out


def cli_eval(data_yaml: str, checkpoint: str, batch: int, *extra: str) -> dict:
    return json.loads(run_module("mobilenet_yolo_tpu_torch.cli.eval", "-y", data_yaml, "-c",
                                 checkpoint, "--batch-size", str(batch), *extra))


def mbv3_cli(smi: str) -> tuple[dict, object, Path]:
    """MBv3-YOLO through the train, eval and infer CLIs on the data phase's
    shards, each its own process: the fit recipe for ``MBV3_EPOCHS`` epochs,
    the loss ratio held to ``MBV3_LOSS_RATIO``, the mAP printed; beside the
    eval and infer CLIs, ``tools.prune --backbone mbv3`` cuts the
    checkpoint. Returns the data yaml, the config, the checkpoint directory
    and the cut's."""
    data_yaml = str(DATA_DIR / "data.yaml")
    data, cfg = load_yaml(data_yaml), load_config(data_yaml)
    mc = cfg.model
    ckpt = MBV3_DIR / "ck"
    rows, _ = cli_fit("mbv3", "cli_train", data_yaml, ckpt, MBV3_EPOCHS, "--backbone", "mbv3",
                   smi=smi)
    ratio = rows[-1, 1] / rows[0, 1]
    check(ratio <= MBV3_LOSS_RATIO, f"mbv3 fit: loss of epoch {MBV3_EPOCHS} / epoch 1 = "
                                    f"{ratio:.4f} <= {MBV3_LOSS_RATIO}")
    first = Path(data["test_dataset_path"]["lists"][0]).read_text().split()[0]
    image = DATA_DIR / "JPEGImages" / f"{first}.jpg"
    cut = MBV3_DIR / f"cut{round(MBV3_CUT * 100)}"
    ev, out, pruned = run_modules(
        ("mobilenet_yolo_tpu_torch.cli.eval", "-y", data_yaml, "-c", str(ckpt), "--batch-size",
         str(mc["batch_size"]), "--backbone", "mbv3"),
        ("mobilenet_yolo_tpu_torch.cli.infer", "--backbone", "mbv3", "-y", data_yaml, "-c",
         str(ckpt), "-i", str(image), "--out-dir", str(MBV3_DIR / "infer")),
        ("mobilenet_yolo_tpu_torch.tools.prune", "--backbone", "mbv3", "-y", data_yaml, "-c",
         str(ckpt), "--ratio", str(MBV3_CUT), "--out", str(cut)))
    ev = json.loads(ev)
    check((MBV3_DIR / "infer" / f"{image.stem}_result.jpg").is_file(),
          "cli/infer served the MBv3 checkpoint")
    report("mbv3", what="cli", loss_ratio=f"{ratio:.4f}", bar_ratio=MBV3_LOSS_RATIO,
           log_mAP=f"{rows[-1, 2]:.6f}", eval_mAP=f"{ev['mAP']:.6f}", val_conf=ev["val_conf"],
           held_mAP=False, infer=out.strip().splitlines()[1], card=f"'{smi}'")
    check(all((cut / name).is_file() for name in ("params.npz", "data.yaml", "summary.json")),
          f"tools.prune --backbone mbv3 wrote the cut:\n{pruned[-2000:]}")
    return data, cfg, ckpt, cut


def cut_eval_cli(cut: Path, batch: int) -> dict:
    """The MBv3 cut scored by the eval CLI at ``MBV3_CUT_CONF``, its own
    process."""
    return cli_eval(str(cut / "data.yaml"), str(cut / "params.npz"), batch, "--backbone", "mbv3",
                    "--val-conf", str(MBV3_CUT_CONF))


def phase_mbv3(device, smi: str) -> dict:
    """MobileNetV3-YOLO and MBv3-YOLO MACC-lite on the card at the VOC
    contract: b128 at 352x352 served in float32 and bf16, unfolded and
    folded (the NMS kernel once a request), a CPU float64 slice held against
    the card's; a plain and a geometry step per dtype (``aug_compose`` once
    a geometry step); meanwhile MBv3-YOLO trained, evaluated and served
    through the CLIs on the data phase's shards (``mbv3_cli``); then one fed
    epoch in this process and the serving times. Returns the kernels'
    launches on the phase's main path."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(MBV3_DIR, ignore_errors=True)
    MBV3_DIR.mkdir(parents=True)
    # the CLIs' processes (CPU-bound as the loader feeds them) run beside
    # this process's requests and steps, which are checked, not timed
    background = ThreadPoolExecutor(1)
    cli = background.submit(mbv3_cli, smi)
    rng = np.random.default_rng(SEED + 20)
    calib = torch.from_numpy(rng.normal(0.0, 1.0, (MBV3_CALIB, SIZE, SIZE, 3))
                             .astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    x128 = torch.randn((BATCH, SIZE, SIZE, 3), generator=gen, device=device)
    val_conf = torch.tensor(VAL_CONF, device=device)
    geom = geometry_tensors(random_geometry_batch(rng, TRAIN_BATCH, SIZE), device)
    host = resident_batch("host", device)

    # the main path: every request and step of both graphs, counts read around them
    for counted in LAUNCH_COUNTERS:
        counted.launches = 0
    models, requests, steps = {}, 0, 0
    for backbone in MBV3_BACKBONES:
        model = build_model(VOC_CONFIG, backbone, device="cpu",
                            generator=torch.Generator().manual_seed(SEED))
        model = model.to(device)
        calibrate_bn(model, calib)
        cpu64 = copy.deepcopy(model).cpu().double()
        model = model.to(memory_format=torch.channels_last)
        folded = fold_batchnorm(model)
        models[backbone] = (model, folded, VOC_CONFIG)
        predict = {name: make_predict_fn(folded if fold else model, VOC_CONFIG, dtype=dtype)
                   for name, (fold, dtype) in MBV3_DTYPES.items()}
        results = {name: f(x128, val_conf) for name, f in predict.items()}
        requests += len(predict)
        for name, (dets, keep) in results.items():
            valid = dets[..., 4] > val_conf
            check(bool(torch.isfinite(dets).all()), f"{backbone} {name}: detections finite")
            check(0 < int(keep.sum()) < int(valid.sum()), f"{backbone} {name}: NMS kept some "
                                                          "and cut some")
            report("mbv3", backbone=backbone, request=f"{name}_b{BATCH}", kept=int(keep.sum()),
                   valid=int(valid.sum()))
        # the whole slice, card vs CPU, in float64 on a few images
        small = x128[:2].double()
        want_dets, want_keep = make_predict_fn(cpu64, VOC_CONFIG)(small.cpu(), val_conf.cpu())
        dets, keep = (t.cpu() for t in make_predict_fn(cpu64.to(device), VOC_CONFIG)(
            small, val_conf))
        requests += 1
        check(torch.equal(keep, want_keep), f"{backbone}: float64 slice keep, card == CPU")
        dets_err = float((dets[keep] - want_dets[keep]).abs().max())
        check(dets_err <= DETS_TOL, f"{backbone}: float64 kept detections, card vs CPU "
                                    f"{dets_err:.3g}")
        # folded against unfolded float32 heads; bf16 against float32, printed
        heads = {name: head_logits(folded if fold else model, x128[:2], dtype)
                 for name, (fold, dtype) in MBV3_DTYPES.items()}
        fold_err = max(rel_err(heads["folded_f32"][k], heads["f32"][k]) for k in HEADS)
        check(fold_err <= FOLD_F32_REL_TOL,
              f"{backbone}: folded f32 heads vs unfolded {fold_err:.3g} <= {FOLD_F32_REL_TOL}")
        report("mbv3", backbone=backbone, kept=int(keep.sum()), keep_equal=True,
               dets_max_abs_err=f"{dets_err:.3g}", folded_vs_unfolded_f32_rel=f"{fold_err:.3g}",
               tol=FOLD_F32_REL_TOL, held_bf16=False,
               bf16_vs_f32_rel=f"{max(rel_err(heads['bf16'][k], heads['f32'][k]) for k in HEADS):.3g}",
               folded_bf16_vs_f32_rel=f"{max(rel_err(heads['folded_bf16'][k], heads['f32'][k]) for k in HEADS):.3g}")
        # a plain and a geometry step per dtype, batch 32
        for dt_name, dtype in DTYPES.items():
            trained = copy.deepcopy(model)
            state = create_train_state(trained)
            _, plain = make_train_step(trained, VOC_CONFIG, dtype=dtype)(
                state, host["images"], host["gt"], host["n_gt"])
            _, geo = make_geometry_train_step(trained, VOC_CONFIG, dtype=dtype)(
                state, *step_args(geom, AUG_SEED), out_hw=(SIZE, SIZE))
            steps += 1
            losses = (float(plain["loss"]), float(geo["loss"]))
            check(all(np.isfinite(losses)), f"{backbone} {dt_name} step losses {losses}")
            report("mbv3", backbone=backbone, dtype=dt_name, batch=TRAIN_BATCH,
                   plain_loss=f"{losses[0]:.5f}", geometry_loss=f"{losses[1]:.5f}")
    torch.cuda.synchronize()
    launches = {"nms_suppress": suppress.launches, "aug_compose": aug_compose.launches}
    check(launches == {"nms_suppress": requests, "aug_compose": steps},
          f"mbv3 launches {launches}: one scan a request ({requests}), one compose a "
          f"geometry step ({steps})")
    fused = {name: fn.launches for name, fn in FUSED.items()}
    check(not any(fused.values()), f"the folded MBv3 graphs ran no MBv2 fused kernel: {fused}")
    # MACC-lite's head site, cut in this process while the CLIs run
    before = suppress.launches
    cut_macc_head(device, models, calib, x128)
    macc_requests = suppress.launches - before

    # the CLIs' processes, started with the phase, have run beside the above
    t0 = time.perf_counter()
    data, cfg, ckpt, cut = cli.result()
    waited = time.perf_counter() - t0
    mc = cfg.model

    # one fed epoch of the trained MBv3 in this process
    raw = CheckpointManager(str(ckpt)).restore_latest_raw()
    model = build_model(mc, "mbv3", device=device)
    model.load_state_dict(served_state_dict(raw))
    trainer = Trainer(model, mc, cfg.classes,
                      TrainerConfig(checkpoint_dir=str(MBV3_DIR / "in_process"),
                                    nms_top_k=FIT_TOP_K),
                      verbose=False, device_normalize=True, device_geometry=True, device=device)
    fed_epoch("mbv3", "loader", trainer, mc, data, 0, MBV3_EPOCHS, device, smi)
    torch.cuda.synchronize()
    # the MACC-lite cut's requests count on the cuts' path
    launches = {"nms_suppress": suppress.launches - macc_requests,
                "aug_compose": aug_compose.launches}

    # the pruned MBv3 (the cut of the CLI's checkpoint) in this process,
    # beside the eval CLI scoring it (checked, not timed)
    t0 = time.perf_counter()
    cut_eval = background.submit(cut_eval_cli, cut, mc["batch_size"])
    for counted in LAUNCH_COUNTERS:
        counted.launches = 0
    models["mbv3_cut30"], cut_launches = serve_mbv3_cut(device, smi, cut, cut_eval, data, cfg,
                                                         x128, geom)
    background.shutdown()
    cut_launches["nms_suppress"] += macc_requests
    check(not any(fn.launches for fn in FUSED.values()),
          "the MBv3 cut ran no MBv2 fused kernel")
    report("mbv3", what="cut_seconds", waited_for_cli_s=f"{waited:.1f}",
           cut_s=f"{time.perf_counter() - t0:.1f}")

    # timing: b128 per mode, b1 latency (CUDA events, TF32 off)
    for backbone, (model, folded, net_cfg) in models.items():
        times = {}
        for name, (fold, dtype) in MBV3_DTYPES.items():
            f = make_predict_fn(folded if fold else model, net_cfg, dtype=dtype)
            times[f"b{BATCH}_{name}_ms"] = f"{cuda_ms(lambda: f(x128, val_conf), iters=MBV3_ITERS):.3f}"
        f = make_predict_fn(model, net_cfg)
        times["b1_f32_ms"] = f"{cuda_ms(lambda: f(x128[:1], val_conf), iters=20):.3f}"
        report("timing", what=f"{backbone}_predict", **times, tf32=False, card=f"'{smi}'")
    report("mbv3", mbv3_launches=launches, mbv3_cut_launches=cut_launches,
           phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=f"'{smi}'")
    return launches, cut_launches


def serve_mbv3_cut(device, smi: str, cut: Path, cut_eval, data: dict, cfg,
                   x128: torch.Tensor, geom: dict) -> tuple[tuple, dict]:
    """The MBv3 cut (``tools.prune --backbone mbv3`` of the CLI's checkpoint,
    in ``cut``): its test mAP in this process against the eval CLI's
    (``cut_eval``, the future of ``cut_eval_cli``; both at torch's default
    precision), its widths and parameters beside the parent's; served at
    b128 (the test images twice) in float32 and bf16, unfolded and folded,
    the NMS kernel once a request; a float64 slice card vs CPU, folded
    float32 heads against unfolded; one geometry step (``aug_compose``
    once). Returns the cut's (model, folded, config) and the launches."""
    mc = cfg.model
    bs = mc["batch_size"]
    cut_cfg = load_config(str(cut / "data.yaml"))
    mcc = cut_cfg.model
    summary = json.loads((cut / "summary.json").read_text())
    model = load_variables(build_model(mcc, "mbv3", device=device),
                           str(cut / "params.npz")).eval()
    parent = build_model(mc, "mbv3", device="cpu")
    widths = {name: [g.size for g in prune.prunable_gammas(net.state_dict()).values()]
              for name, net in (("parent", parent), ("cut", model))}
    check(prune.param_count(model) == summary["params_after"] < summary["params_before"]
          == prune.param_count(parent), f"the cut's parameters {summary}")
    test = Loader(DetectionDataset(records.RecordReader(data["test_dataset_path"]["lmdb"]),
                                   phase="test"), bs, [[mc["img_w"], mc["img_h"]]],
                  mc["normalize"]["mean"], mc["normalize"]["std"], shuffle=False,
                  pad_final=False)
    n_eval = -(-DATA_TEST // bs)
    # at torch's default precision, as the eval CLI's process ran
    torch.backends.cudnn.allow_tf32 = True
    res = evaluate_detection(make_predict_fn(model, mcc, top_k=FIT_TOP_K), test, cut_cfg.classes,
                             MBV3_CUT_CONF, batch_size=bs, device=device)
    torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32 = False
    check(suppress.launches == n_eval, f"the cut's eval: suppress once a batch ({suppress.launches})")

    # served at b128 per mode, a float64 slice card vs CPU, folded vs unfolded
    images = torch.from_numpy(np.concatenate([b["images"] for b in test])).to(device)
    x = torch.cat([images] * -(-BATCH // len(images)))[:BATCH]
    cpu64 = copy.deepcopy(model).cpu().double()
    model = model.to(memory_format=torch.channels_last)
    folded = fold_batchnorm(model)
    served = serve_cut("mbv3_cut30", model, folded, mcc, x, cpu64, MBV3_CUT_CONF, MBV3_DTYPES)
    # one geometry step at batch 32
    trained = copy.deepcopy(model)
    before = {k: v.detach().clone() for k, v in trained.state_dict().items()}
    _, m = make_geometry_train_step(trained, mcc)(create_train_state(trained),
                                                  *step_args(geom, AUG_SEED), out_hw=(SIZE, SIZE))
    torch.cuda.synchronize()
    moved = sum(not torch.equal(v, before[k]) for k, v in trained.state_dict().items())
    check(np.isfinite(float(m["loss"])) and moved > 0 and aug_compose.launches == 1,
          f"the cut's geometry step: loss {float(m['loss'])}, {moved} tensors moved, "
          f"aug_compose {aug_compose.launches}")
    report("mbv3", what="cut_step", batch=TRAIN_BATCH, loss=f"{float(m['loss']):.5f}",
           tensors_moved=moved, launches=aug_compose.launches)
    launches = {"nms_suppress": suppress.launches, "aug_compose": aug_compose.launches}
    check(launches == {"nms_suppress": n_eval + served, "aug_compose": 1},
          f"the cut's launches {launches}: the scan once an eval batch and a request")

    cli = cut_eval.result()
    err = abs(res["mAP"] - cli["mAP"])
    report("mbv3", what="cut_eval", ratio=MBV3_CUT, hidden_parent=widths["parent"],
           hidden_cut=widths["cut"], params_parent=summary["params_before"],
           params_cut=summary["params_after"], gate=MBV3_CUT_CONF, mAP=f"{res['mAP']:.6f}",
           cli_mAP=f"{cli['mAP']:.6f}", abs_err=f"{err:.3g}", tol=FIT_EVAL_MAP_TOL,
           margin=f"{FIT_EVAL_MAP_TOL - err:.3g}", held_mAP=False, card=f"'{smi}'")
    check(err <= FIT_EVAL_MAP_TOL, f"the cut's mAP here {res['mAP']} vs cli.eval's {cli['mAP']}")
    return (model, folded, mcc), launches


def cut_macc_head(device, models: dict, calib: torch.Tensor, x128: torch.Tensor) -> None:
    """MACC-lite's head site: the phase's seeded, calibrated MACC-lite with
    its prunable gammas scaled by seeded factors (at init every gamma is 1,
    which ties every channel), cut by ``plan_prune`` / ``apply_prune`` with
    its ``backbone_head``, its BatchNorm statistics calibrated again on
    ``calib`` (the scaled gammas moved every layer's input; uncalibrated,
    its scores saturate and tie), served at b128 float32 with a float64
    slice card vs CPU."""
    macc = copy.deepcopy(models["mbv3_macc"][0]).cpu()
    gen = torch.Generator().manual_seed(SEED + 21)
    params = dict(macc.named_parameters())
    with torch.no_grad():
        for site in prune.prunable_gammas(macc.state_dict()):
            g = params[prune._gamma_key(site)]
            g.mul_(0.5 + torch.rand(g.shape, generator=gen))
    state = {k: v.detach() for k, v in macc.state_dict().items()}
    plan = prune.plan_prune(state, MBV3_CUT)
    macc_state, macc_plan = prune.apply_prune(state, plan)
    check(macc_plan.get("backbone_head", 0) < state["backbone.head_conv.bn.weight"].numel(),
          f"the MACC-lite plan cuts the head site: {macc_plan}")
    macc_cut = build_model(dict(VOC_CONFIG, prune=macc_plan), "mbv3_macc", device="cpu")
    macc_cut.load_state_dict(macc_state, strict=True)
    macc_cut = macc_cut.to(device)
    calibrate_bn(macc_cut, calib)
    macc64 = copy.deepcopy(macc_cut).cpu().double().eval()
    macc_cut = macc_cut.eval().to(memory_format=torch.channels_last)
    serve_cut("mbv3_macc_cut30", macc_cut, None, VOC_CONFIG, x128, macc64, VAL_CONF,
              {"f32": (False, None)})
    report("mbv3", what="macc_head_cut", head=macc_plan["backbone_head"],
           head_parent=state["backbone.head_conv.bn.weight"].numel(),
           hidden=macc_plan["backbone_hidden"], params_parent=prune.param_count(macc),
           params_cut=prune.param_count(macc_cut))


def serve_cut(name: str, model, folded, mc: dict, x: torch.Tensor, cpu64, gate: float,
              dtypes: dict) -> int:
    """A cut served at ``x``'s batch per mode of ``dtypes`` (the NMS kernel
    once a request), the whole slice card vs CPU in float64 on two images,
    and with a folded model its float32 heads against the unfolded ones
    (``FOLD_F32_REL_TOL``). The slice's gate lies in a gap of the CPU's
    scores (``slice_gate``), and its detections above the gate and those
    kept are held as sets (``rows_err``, ``DETS_TOL``): a trained model's
    scores crowd, and the float32 decode may order two that lie a few ulp
    apart otherwise on each device. Returns the requests made."""
    device = x.device
    val_conf = torch.tensor(gate, device=device)
    before = suppress.launches
    for mode, (fold, dtype) in dtypes.items():
        dets, keep = make_predict_fn(folded if fold else model, mc, dtype=dtype)(x, val_conf)
        check(bool(torch.isfinite(dets).all()), f"{name} {mode}: detections finite")
        report("mbv3", cut=name, request=f"{mode}_b{x.shape[0]}", kept=int(keep.sum()),
               valid=int((dets[..., 4] > val_conf).sum()))
    torch.cuda.synchronize()
    check(suppress.launches - before == len(dtypes), f"{name}: suppress once a request")
    small = x[:2].double()
    predict64 = make_predict_fn(cpu64, mc)
    low = slice_gate(predict64(small.cpu(), torch.tensor(0.0, dtype=torch.float64))[0][..., 4])
    want_dets, want_keep = predict64(small.cpu(), torch.tensor(low, dtype=torch.float64))
    dets, keep = (t.cpu() for t in make_predict_fn(cpu64.to(device), mc)(
        small, torch.tensor(low, dtype=torch.float64, device=device)))
    errs = [rows_err(got[got[:, 4] > low], want[want[:, 4] > low])
            for got, want in zip(dets, want_dets)]
    errs += [rows_err(got[k], want[k_want])
             for got, k, want, k_want in zip(dets, keep, want_dets, want_keep)]
    dets_err = max(errs)
    check(bool(want_keep.any()) and dets_err <= DETS_TOL,
          f"{name}: float64 slice above gate {low:.6g} and kept, card vs CPU {dets_err:.3g}")
    fold_err = "none"
    if folded is not None:
        heads = (head_logits(folded, x[:2]), head_logits(model, x[:2]))
        fold_err = max(rel_err(heads[0][k], heads[1][k]) for k in HEADS)
        check(fold_err <= FOLD_F32_REL_TOL,
              f"{name}: folded f32 heads vs unfolded {fold_err:.3g} <= {FOLD_F32_REL_TOL}")
        fold_err = f"{fold_err:.3g}"
    report("mbv3", cut=name, slice_gate=f"{low:.6g}", valid=int((want_dets[..., 4] > low).sum()),
           kept=int(want_keep.sum()), dets_max_abs_err=f"{dets_err:.3g}", tol=DETS_TOL,
           folded_vs_unfolded_f32_rel=fold_err, fold_tol=FOLD_F32_REL_TOL)
    return len(dtypes) + 1


def slice_gate(scores: torch.Tensor) -> float:
    """A gate for a float64 slice from the CPU's top-K scores (images, K):
    the middle of the widest gap between two of the pooled scores ranked
    K/2 to 3K/4, so that each image keeps fewer than K rows above it (the
    top-K boundary cannot flip a row in) and no score lies near it."""
    k = scores.shape[1]
    s = scores.flatten().sort(descending=True).values[k // 2:3 * k // 4 + 1]
    i = int((s[:-1] - s[1:]).argmax())
    check(float(s[i] - s[i + 1]) > SLICE_GAP, f"the slice's scores leave a gap: {s[i]}, {s[i + 1]}")
    return float(s[i] + s[i + 1]) / 2


def rows_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference between two sets of detection rows (N, 7),
    each row of ``want`` (by descending score) matched to the closest row
    of ``got`` left; inf where their counts differ."""
    if got.shape != want.shape:
        return float("inf")
    left = list(range(got.shape[0]))
    worst = 0.0
    for row in want[want[:, 4].argsort(descending=True)]:
        d = (got[left] - row).abs().amax(dim=1)
        j = int(d.argmin())
        worst = max(worst, float(d[j]))
        left.pop(j)
    return worst


# ------------------------------------------------------------------ dist --


def build_bdd_shards(smi: str, built=None) -> dict:
    """The BDD-style tree and its shards (``fabricate_bdd``, or the future
    ``built`` of it); read every record back: its labels against its JSON
    after the class map, its seg map against its PNG. Returns the data
    yaml."""
    import cv2
    from PIL import Image

    fabricate_s, build_s = built.result() if built else fabricate_bdd()
    data = load_yaml(str(BDD_DIR / "data.yaml"))
    kept, original = data["classes"]["map"], data["classes"]["original"]
    check(len(kept) < len(original), f"the class map drops classes: {original} -> {kept}")
    n_boxes, n_dropped, seg_ids = 0, 0, set()
    for split, n in (("trainval_dataset_path", BDD_TRAIN), ("test_dataset_path", BDD_TEST)):
        paths = data[split]
        reader = records.RecordReader(paths["lmdb"])
        check(len(reader) == n, f"{split}: {len(reader)} records, {n} written")
        names = Path(paths["lists"][0]).read_text().split()
        for i, name in enumerate(names):
            rec = reader[i]
            w, h = Image.open(io.BytesIO(rec.image_bytes)).size  # the JPEG's header
            anno = Path(paths["annos"][0]) / f"{name}.json"
            boxes, labels, diffs = parse_coco_json(str(anno), kept, original)
            want = to_yolo_labels(boxes, [label + 1 for label in labels], diffs, w, h)
            check(np.array_equal(rec.labels, want), f"{split} record {i} ({name}) labels")
            n_boxes += len(want)
            n_dropped += len(json.loads(anno.read_text())["annotation"]) - len(want)
            seg = cv2.imread(str(Path(paths["segs"][0]) / f"{name}.png"), cv2.IMREAD_UNCHANGED)
            got = _decode_seg(rec.seg_bytes)
            check(seg.ndim == 2 and np.array_equal(got, seg), f"{split} record {i} ({name}) seg")
            seg_ids.update(np.unique(got).tolist())
    check(n_dropped > 0 and seg_ids == {0, 1, 2},
          f"the map dropped boxes ({n_dropped}); seg ids {sorted(seg_ids)}")
    report("bdd", what="build", fabricate_s=f"{fabricate_s:.2f}", build_dataset_s=f"{build_s:.2f}",
           records=BDD_TRAIN + BDD_TEST, boxes=n_boxes, dropped_by_map=n_dropped,
           seg_ids=sorted(seg_ids), labels_read_back=True, seg_read_back=True,
           card=f"'{smi}'")
    return data


def bdd_test_loader(mc: dict, data: dict, batch: int, prefetch: int = DATA_PREFETCH) -> Loader:
    """The eval CLI's loader over the BDD test shard: float images, seg maps."""
    norm = mc["normalize"]
    ds = DetectionDataset(records.RecordReader(data["test_dataset_path"]["lmdb"]), phase="test",
                          has_seg=True, seg_num_classes=mc["seg"]["num_classes"])
    return Loader(ds, batch, [[mc["img_w"], mc["img_h"]]], norm["mean"], norm["std"],
                  shuffle=False, pad_final=False, prefetch=prefetch)


def constant_seg_baselines(mc: dict, data: dict) -> dict:
    """The seg metrics' mIoU of constant predictions over the test maps:
    ``majority``, every pixel the test maps' most frequent class (the
    background, id 0, when no channel holds most pixels), and ``best``,
    the best of every constant on/off map of the seg channels."""
    truth = np.concatenate([b["seg_maps"] for b in bdd_test_loader(mc, data, BDD_TEST, 0)])
    t = torch.from_numpy(truth)
    n_classes = t.shape[-1]
    pixels = [int((t < 0.5).all(-1).sum())] + [int((t[..., c] >= 0.5).sum())
                                               for c in range(n_classes)]

    def miou(channels) -> float:
        pred = torch.zeros_like(t)
        for c in channels:
            pred[..., c] = 1.0
        acc = SegMetricAccumulator(n_classes)
        acc.add_batch(pred, t)
        return acc.compute()[1]

    majority = int(np.argmax(pixels))
    best = max(miou([c for c in range(n_classes) if mask >> c & 1])
               for mask in range(2 ** n_classes))
    return {"pixels_by_id": pixels, "majority_id": majority,
            "majority": miou([majority - 1] if majority else []), "best": best}


def bdd_cli(smi: str, built=None) -> dict:
    """The bdd phase's processes: the fabricated tree built (and read back),
    trained and scored by the CLIs, each its own process. The loss ratio
    and the seg mIoU against the constant predictions' are held. Returns
    the data yaml, the config and the checkpoint directory. ``built``: as
    for ``build_bdd_shards``."""
    t0 = time.perf_counter()
    data = build_bdd_shards(smi, built)
    data_yaml = str(BDD_DIR / "data.yaml")
    cfg = load_config(data_yaml)
    mc = cfg.model
    check(cfg.segmentation_enabled and mc["seg"]["num_classes"] == 2,
          "the fabricated tree's model has a 2-class seg head")
    base = constant_seg_baselines(mc, data)
    bar = max(base["majority"], base["best"])

    # 3: the CLIs train and score it
    ckpt = BDD_DIR / "ck"
    rows, out = cli_fit("bdd", "cli_train", data_yaml, ckpt, BDD_EPOCHS, "--learning_rate",
                        BDD_LR, smi=smi)
    ratio = rows[-1, 1] / rows[0, 1]
    seg_by_eval = re.findall(r"seg mIoU ([0-9.]+)", out)
    ev = cli_eval(data_yaml, str(ckpt), mc["batch_size"])
    report("bdd", what="cli_eval", mAP=f"{ev['mAP']:.6f}", seg_mIoU=f"{ev['seg_mIoU']:.6f}",
           log_mAP=f"{rows[-1, 2]:.6f}", seg_mIoU_by_eval="/".join(seg_by_eval),
           loss_ratio=f"{ratio:.4f}", bar_ratio=BDD_LOSS_RATIO, val_conf=ev["val_conf"],
           majority_id=base["majority_id"], pixels_by_id=base["pixels_by_id"],
           majority_mIoU=f"{base['majority']:.6f}", best_constant_mIoU=f"{base['best']:.6f}",
           card=f"'{smi}'")
    check(ratio <= BDD_LOSS_RATIO, f"bdd fit: loss of epoch {BDD_EPOCHS} / epoch 1 = "
                                   f"{ratio:.4f} <= {BDD_LOSS_RATIO}")
    check(ev["seg_mIoU"] > bar, f"cli.eval seg mIoU {ev['seg_mIoU']} above the constant "
                                f"predictions' {bar}")
    report("bdd", what="processes", seconds=f"{time.perf_counter() - t0:.1f}", card=f"'{smi}'")
    return {"data": data, "cfg": cfg, "ckpt": ckpt}


def phase_bdd(device, smi: str, cli: dict | None = None) -> dict:
    """The BDD100K multi-task path: the fabricated tree built, trained and
    scored by the CLIs (``bdd_cli``, unless ``cli`` holds its result), then
    in this process the checkpoint's mAP and seg mIoU card vs CPU in
    float64 (kernel 1), one segmentation geometry step card vs CPU (kernel
    6), and the published 416x416 model served unfolded and folded
    (kernels 1-4). Returns the kernels' launches on the phase's path."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cli = cli or bdd_cli(smi)
    data, cfg, ckpt = cli["data"], cli["cfg"], cli["ckpt"]
    mc = cfg.model

    # 4: the checkpoint's mAP and seg mIoU, card vs CPU in float64
    for counted in LAUNCH_COUNTERS:
        counted.launches = 0
    raw = CheckpointManager(str(ckpt)).restore_latest_raw()
    model = build_model(mc, device="cpu")
    model.load_state_dict(served_state_dict(raw))
    loader = bdd_test_loader(mc, data, BDD_EVAL_BATCH, 0)
    batches = [dict(b, images=b["images"].astype(np.float64))
               for b, _ in zip(loader, range(BDD_EVAL_BATCHES), strict=False)]
    res = {}
    for side, dev in (("card", device), ("cpu", "cpu")):
        predict = make_predict_fn(copy.deepcopy(model).double().to(dev), mc, top_k=FIT_TOP_K)
        res[side] = evaluate_detection(predict, batches, cfg.classes, float(raw["val_conf"]),
                                       device=dev)
        if side == "card":
            torch.cuda.synchronize()
            check(suppress.launches == len(batches),
                  f"bdd eval: suppress once per batch ({suppress.launches})")
    map_err = abs(res["card"]["mAP"] - res["cpu"]["mAP"])
    miou_err = abs(res["card"]["seg_miou"] - res["cpu"]["seg_miou"])
    report("bdd", what="eval_float64", images=BDD_EVAL_BATCH * len(batches),
           batches=len(batches), mAP_card=f"{res['card']['mAP']:.6f}",
           mAP_cpu=f"{res['cpu']['mAP']:.6f}", seg_miou_card=f"{res['card']['seg_miou']:.6f}",
           seg_miou_cpu=f"{res['cpu']['seg_miou']:.6f}", mAP_abs_err=map_err,
           seg_miou_abs_err=miou_err, tol=EVAL_MAP_TOL, launches=suppress.launches)
    check(map_err <= EVAL_MAP_TOL and miou_err <= EVAL_MAP_TOL,
          f"bdd eval float64: mAP {map_err}, seg mIoU {miou_err} <= {EVAL_MAP_TOL}")
    check(res["card"]["tp"] == res["cpu"]["tp"] and res["card"]["fp"] == res["cpu"]["fp"],
          "bdd eval TP/FP, card == CPU")

    # 5: the segmentation geometry step on BDD_STEP_BATCHES loader batches,
    # noise off. The path's step: the card in float32 (TF32 off) through
    # aug_compose, whose images are held to its twin's at the aug bars. The
    # step card vs CPU on the same inputs (the twin's images, the seg maps):
    # the CPU in float64, the card in float32 and in float64; the gate is
    # BDD_STEP_GATE's reading. The path step against the CPU (the kernel's
    # images against the twin's) is printed beside them.
    norm = mc["normalize"]
    ds = DetectionDataset(records.RecordReader(data["trainval_dataset_path"]["lmdb"]),
                          phase="train", expand_scale=mc["expand_scale"], has_seg=True,
                          seg_num_classes=mc["seg"]["num_classes"], apply_noise=False,
                          apply_photometric=False)
    loader = Loader(ds, BDD_STEP_BATCH, [[BDD_STEP_SIZE, BDD_STEP_SIZE]], norm["mean"],
                    norm["std"], mosaic_num=mc["mosaic_num"], seed=SEED, prefetch=0,
                    device_geometry=True)
    keys = (*GEOMETRY_BATCH_KEYS, "seg_slots", "seg_active", "gt", "n_gt")
    sides = {"f32_kernel": (device, None), "f32_twin": (device, None),
             "f64_twin": (device, torch.float64), "cpu": ("cpu", torch.float64)}
    readings = {name: [] for name in sides if name != "cpu"}
    image_errs, steps = [], 0
    for batch, _ in zip(loader, range(BDD_STEP_BATCHES), strict=False):
        check(not batch["noise_gate"].any() and batch["seg_active"].any(),
              "the step's batch: noise off, seg slots staged")
        out_hw = tuple(batch["out_size"])
        t = {dev: batch_to_device(batch, dev) for dev in (device, "cpu")}
        twin = aug_compose_reference(*compose_args(t["cpu"], AUG_SEED), out_hw)
        seg_maps = seg_compose(t["cpu"]["seg_slots"], t["cpu"]["src_rect"],
                               t["cpu"]["dst_rect"], t["cpu"]["flip"], t["cpu"]["seg_active"],
                               (out_hw[0] // 16, out_hw[1] // 16), mc["seg"]["num_classes"])
        metrics = {}
        for name, (dev, dtype) in sides.items():
            stepped = copy.deepcopy(model).to(dev, dtype or torch.float32)
            state = create_train_state(stepped)
            if name == "f32_kernel":
                step = make_geometry_train_step(stepped, mc, segmentation=True, fused_aug=True)
                before = aug_compose.launches
                _, m = step(state, *(t[dev][k] for k in keys), AUG_SEED, out_hw=out_hw)
                torch.cuda.synchronize()
                check(aug_compose.launches - before == 1, "bdd step: aug_compose launched once")
                steps += 1
            else:
                step = make_train_step(stepped, mc, segmentation=True, normalize=True,
                                       dtype=dtype)
                _, m = step(state, twin.to(dev), t[dev]["gt"], t[dev]["n_gt"], seg_maps.to(dev))
            metrics[name] = {k: float(m[k]) for k in ("loss", "seg_obj", "seg_no_obj")}
            check(all(np.isfinite(list(metrics[name].values()))),
                  f"bdd {name} step {metrics[name]}")
        for name in readings:
            readings[name].append(max(abs(metrics[name][k] - v) / abs(v)
                                      for k, v in metrics["cpu"].items()))
        # the kernel's images against the twin's (the comparison's launch is
        # not the path's)
        before = aug_compose.launches
        image_errs.append(aug_err(aug_compose(*compose_args(t[device], AUG_SEED), out_hw).cpu(),
                                  twin, "bdd step images"))
        aug_compose.launches = before
        report("bdd", what="seg_step", batch=BDD_STEP_BATCH, size=BDD_STEP_SIZE,
               **{f"{k}_{name}": f"{v:.8f}" for name, m in metrics.items()
                  for k, v in m.items()},
               **{f"{name}_rel": f"{v[-1]:.3g}" for name, v in readings.items()},
               image_max_abs_diff=image_errs[-1],
               seg_obj_above_no_obj=metrics["f32_kernel"]["seg_obj"]
               > metrics["f32_kernel"]["seg_no_obj"])
    worst = {name: max(v) for name, v in readings.items()}
    report("bdd", what="seg_step_card_vs_cpu", steps=steps,
           **{f"{name}_max_rel": f"{v:.3g}" for name, v in worst.items()},
           gate=BDD_STEP_GATE, rtol=BDD_STEP_RTOL,
           margin=f"{BDD_STEP_RTOL - worst[BDD_STEP_GATE]:.3g}",
           image_max_abs_diff=max(image_errs), image_tol=AUG_MAX_ERR)
    check(steps == BDD_STEP_BATCHES, f"bdd steps {steps} == {BDD_STEP_BATCHES}")
    check(worst[BDD_STEP_GATE] <= BDD_STEP_RTOL,
          f"bdd seg step card ({BDD_STEP_GATE}) vs CPU float64 on the same inputs "
          f"{worst[BDD_STEP_GATE]} <= {BDD_STEP_RTOL}")

    # 6: the published model at 416x416, batch 32, unfolded and folded (its
    # block shapes are held against the twins by ``phase_fused_kernels``)
    launches = serve_bdd416(device, smi)
    check(min(launches.values()) > 0, f"every kernel of the bdd path launched: {launches}")
    report("bdd", bdd_launches=launches, phase_seconds=f"{time.perf_counter() - t_phase:.1f}",
           card=f"'{smi}'")
    return launches


def hpo_cli(smi: str) -> dict:
    """The HPO sweep as a user runs it: ``python -m
    mobilenet_yolo_tpu_torch.hpo.random_search`` on the bdd phase's data
    yaml (``BASELINE.json`` pairs the sweep with the BDD model), its own
    process from ``HPO_DIR`` (``HPO_TRIALS`` trials of ``HPO_EPOCHS`` epochs,
    seed ``HPO_SEED``, each trial ``cli/train.py``'s fit through the
    tuner-override seam). Checks ``trials.json`` (the seeded draws, one
    intermediate report per in-run eval, the final report the best mAP)
    and each trial's run directory (``log.txt``; the draw's weight decay and
    learning rate in the checkpoint's optimizer). Returns the rows and the
    config of the best trial."""
    from mobilenet_yolo_tpu_torch.cli import train as cli_train
    from mobilenet_yolo_tpu_torch.hpo.random_search import sample_params
    from mobilenet_yolo_tpu_torch.train.schedule import learning_rate_for_epoch

    t0 = time.perf_counter()
    shutil.rmtree(HPO_DIR, ignore_errors=True)
    HPO_DIR.mkdir(parents=True)
    data_yaml = str(BDD_DIR / "data.yaml")
    out = run_module("mobilenet_yolo_tpu_torch.hpo.random_search", "-y", data_yaml, "--trials",
                     str(HPO_TRIALS), "--epochs", str(HPO_EPOCHS), "--seed", str(HPO_SEED),
                     "--workdir", str(HPO_DIR / "runs"), "--out", str(HPO_DIR / "trials.json"),
                     cwd=HPO_DIR)
    seconds = time.perf_counter() - t0
    rows = json.loads((HPO_DIR / "trials.json").read_text())
    space = json.loads((ROOT / "mobilenet_yolo_tpu_torch" / "hpo" / "search_space.json")
                       .read_text())
    rng = np.random.default_rng(HPO_SEED)
    draws = [sample_params(space, rng) for _ in range(HPO_TRIALS)]
    check([r["trial"] for r in rows] == list(range(HPO_TRIALS))
          and [r["params"] for r in rows] == draws,
          f"trials.json holds the seeded draws: {[r['params'] for r in rows]} == {draws}")
    defaults = cli_train.get_params(["-y", data_yaml])
    n_evals = HPO_EPOCHS // TrainerConfig.eval_every
    for r in rows:
        run = HPO_DIR / "runs" / f"trial_{r['trial']}"
        log = read_log(run, HPO_EPOCHS)
        best = r["best_mAP"]
        check(len(r["intermediates"]) == n_evals and r["final_report"] == best
              and np.isfinite(best) and 0.0 <= best <= 1.0 and best == max(r["intermediates"]),
              f"trial {r['trial']}: {n_evals} intermediate reports, final == best mAP: {r}")
        params = r["params"]
        lrs = [learning_rate_for_epoch(params["learning_rate"], e, tuple(defaults.schedule),
                                       tuple(int(w) for w in defaults.warm_up))
               for e in range(HPO_EPOCHS)]
        raw = CheckpointManager(str(run)).restore_latest_raw()
        groups = raw["optimizer"]["param_groups"]
        check(raw["epoch"] == HPO_EPOCHS
              and all(g["weight_decay"] == params["weight_decay"] for g in groups)
              and all(abs(g["lr"] - lrs[-1]) <= 1e-12 * lrs[-1] for g in groups)
              and np.allclose(log[:, 5], lrs, rtol=0, atol=5e-7),
              f"trial {r['trial']}'s run directory records its draw {params}: weight decay "
              f"{[g['weight_decay'] for g in groups]}, lr {[g['lr'] for g in groups]}, "
              f"log {log[:, 5]} vs {lrs}")
        r["seconds"] = float(log[:, 3].sum())
        report("hpo", trial=r["trial"], best_mAP=f"{best:.6f}",
               intermediates=r["intermediates"], final_report=r["final_report"],
               loss_by_epoch="/".join(f"{v:.4f}" for v in log[:, 1]),
               lr=params["learning_rate"], weight_decay=params["weight_decay"],
               mosaic_num=params["mosaic_num"], seconds=f"{r['seconds']:.1f}", card=f"'{smi}'")
    best = max(rows, key=lambda r: r["best_mAP"])
    check(f'"best_trial": {best["trial"]}' in out, f"the sweep named trial {best['trial']}")
    report("hpo", what="processes", trials=HPO_TRIALS, epochs=HPO_EPOCHS, seed=HPO_SEED,
           best_trial=best["trial"], seconds=f"{seconds:.1f}", card=f"'{smi}'")
    overrides = {k: v for k, v in best["params"].items()
                 if k not in ("learning_rate", "weight_decay")}
    return {"best": best, "cfg": load_config(data_yaml, overrides), "data": load_yaml(data_yaml)}


def phase_hpo(device, smi: str, sweep: dict) -> dict:
    """The sweep's best trial in this process: its checkpoint evaluated on
    the card at the gate its in-run eval used (a fresh state's), at torch's
    default precision as the trial ran, against the logged best mAP within
    ``FIT_EVAL_MAP_TOL``; kernel 1 once a batch. Returns its launches."""
    best, cfg, data = sweep["best"], sweep["cfg"], sweep["data"]
    mc = cfg.model
    raw = CheckpointManager(str(HPO_DIR / "runs" / f"trial_{best['trial']}")).restore_latest_raw()
    model = build_model(mc, device=device)
    model.load_state_dict(served_state_dict(raw))
    n_eval = -(-BDD_TEST // mc["batch_size"])
    for counted in LAUNCH_COUNTERS:
        counted.launches = 0
    torch.backends.cudnn.allow_tf32 = True
    res = evaluate_detection(make_predict_fn(model, mc, top_k=FIT_TOP_K),
                             bdd_test_loader(mc, data, mc["batch_size"]), cfg.classes,
                             TrainState.val_conf, batch_size=mc["batch_size"], device=device)
    torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32 = False
    launches = {"nms_suppress": suppress.launches}
    err = abs(res["mAP"] - best["best_mAP"])
    report("hpo", what="best_trial_eval", trial=best["trial"], gate=TrainState.val_conf,
           mAP=f"{res['mAP']:.6f}", logged_best_mAP=f"{best['best_mAP']:.6f}",
           abs_err=f"{err:.3g}", tol=FIT_EVAL_MAP_TOL, margin=f"{FIT_EVAL_MAP_TOL - err:.3g}",
           seg_mIoU=f"{res['seg_miou']:.6f}", launches=launches, card=f"'{smi}'")
    check(launches["nms_suppress"] == n_eval, f"the best trial's eval: suppress once a batch")
    check(err <= FIT_EVAL_MAP_TOL, f"the best trial's mAP {res['mAP']} vs its logged "
                                   f"{best['best_mAP']}")
    return launches


def serve_bdd416(device, smi: str) -> dict:
    """The published BDD model (7 classes, seg 2; seeded, BatchNorm
    calibrated) served at batch 32, 416x416, unfolded and folded in float32
    and bf16: detections and sigmoid seg maps of a float64 slice card vs
    CPU, folded float32 heads and seg against unfolded, each request's
    launches and b32 ms. Returns the kernels' counts read right after the
    requests."""
    mc = BDD_SERVE_CONFIG
    size = mc["img_h"]
    rng = np.random.default_rng(SEED + 40)
    model = build_model(mc, device="cpu", generator=torch.Generator().manual_seed(SEED))
    model = model.to(device)
    calibrate_bn(model, torch.from_numpy(
        rng.normal(0.0, 1.0, (4, size, size, 3)).astype(np.float32)).to(device))
    cpu64 = copy.deepcopy(model).cpu().double()
    model = model.to(memory_format=torch.channels_last)
    folded = fold_batchnorm(model)
    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    x = torch.randn((BDD_SERVE_BATCH, size, size, 3), generator=gen, device=device)
    val_conf = torch.tensor(VAL_CONF, device=device)
    before = {"nms_suppress": suppress.launches, **{k: fn.launches for k, fn in FUSED.items()}}
    predict = {name: make_predict_fn(folded if fold else model, mc, dtype=dtype)
               for name, (fold, dtype) in BDD_SERVE_DTYPES.items()}
    for name, fn in predict.items():
        dets, keep, seg = fn(x, val_conf)
        valid = dets[..., 4] > val_conf
        check(bool(torch.isfinite(dets).all()) and bool(torch.isfinite(seg).all()),
              f"bdd416 {name}: detections and seg finite")
        check(seg.shape == (BDD_SERVE_BATCH, size // 16, size // 16, mc["seg"]["num_classes"]),
              f"bdd416 {name}: seg {tuple(seg.shape)}")
        check(0 < int(keep.sum()) < int(valid.sum()), f"bdd416 {name}: NMS kept some and cut some")
        report("bdd", request=f"{name}_b{BDD_SERVE_BATCH}_{size}", kept=int(keep.sum()),
               valid=int(valid.sum()), seg=tuple(seg.shape))
    torch.cuda.synchronize()
    want = {"nms_suppress": len(predict),
            **{k: n * sum(fold for fold, _ in BDD_SERVE_DTYPES.values())
               for k, n in FUSED_PER_REQUEST.items()}}
    got = {k: (suppress.launches if k == "nms_suppress" else FUSED[k].launches) - before[k]
           for k in before}
    check(got == want, f"bdd416 launches {got} == per request {want}")
    launched = {"nms_suppress": suppress.launches, "aug_compose": aug_compose.launches,
                **{k: fn.launches for k, fn in FUSED.items()}}

    # the whole slice, card vs CPU, in float64 on two images
    small = x[:2].double()
    want_dets, want_keep, want_seg = make_predict_fn(cpu64, mc)(small.cpu(), val_conf.cpu())
    dets, keep, seg = (t.cpu() for t in make_predict_fn(cpu64.to(device), mc)(small, val_conf))
    check(torch.equal(keep, want_keep), "bdd416: float64 slice keep, card == CPU")
    dets_err = float((dets[keep] - want_dets[keep]).abs().max())
    seg_err = float((seg - want_seg).abs().max())
    check(dets_err <= DETS_TOL and seg_err <= DETS_TOL,
          f"bdd416 float64 slice, card vs CPU: dets {dets_err:.3g}, seg {seg_err:.3g}")
    # folded against unfolded float32 heads and seg; bf16 printed
    heads = {name: head_logits(folded if fold else model, x[:2], dtype)
             for name, (fold, dtype) in BDD_SERVE_DTYPES.items()}
    outs = (*HEADS, "seg")
    fold_err = max(rel_err(heads["folded_f32"][k], heads["f32"][k]) for k in outs)
    check(fold_err <= FOLD_F32_REL_TOL,
          f"bdd416 folded f32 heads and seg vs unfolded {fold_err:.3g} <= {FOLD_F32_REL_TOL}")
    ms = {name: cuda_ms(lambda fn=fn: fn(x, val_conf), iters=10) for name, fn in predict.items()}
    report("bdd", what="serve_416", kept=int(keep.sum()), keep_equal=True,
           dets_max_abs_err=f"{dets_err:.3g}", seg_max_abs_err=f"{seg_err:.3g}", tol=DETS_TOL,
           folded_vs_unfolded_f32_rel=f"{fold_err:.3g}", fold_tol=FOLD_F32_REL_TOL,
           bf16_vs_f32_rel=f"{max(rel_err(heads['bf16'][k], heads['f32'][k]) for k in outs):.3g}",
           folded_bf16_vs_f32_rel=f"{max(rel_err(heads['folded_bf16'][k], heads['f32'][k]) for k in outs):.3g}",
           **{f"b{BDD_SERVE_BATCH}_{name}_ms": f"{v:.3f}" for name, v in ms.items()},
           card=f"'{smi}'")
    return launched


def dist_loader(mc: dict, data: dict, part: tuple[int, int]) -> Loader:
    """The train CLI's geometry-mode loader over the data phase's shards at
    the dist phase's global batch, cut to rows ``part`` = (index, count),
    as a rank's loader cuts them."""
    ds = DetectionDataset(records.RecordReader(data["trainval_dataset_path"]["lmdb"]),
                          phase="train", expand_scale=mc["expand_scale"], apply_photometric=False)
    norm = mc["normalize"]
    return Loader(ds, DIST_BATCH, mc["train_img_size"], norm["mean"], norm["std"],
                  mosaic_num=mc["mosaic_num"], output_uint8=True, device_geometry=True,
                  seed=SEED, prefetch=0, shard_by_process=True, process_slice=part)


def dist_batches(mc: dict, data: dict, part: tuple[int, int], n: int) -> list[dict]:
    loader = dist_loader(mc, data, part)
    loader.set_epoch(0)
    return [b for _, b in zip(range(n), loader)]


def geometry_args(t: dict) -> tuple:
    return (*(t[k] for k in GEOMETRY_BATCH_KEYS), t["gt"], t["n_gt"])


def state_arrays(model) -> dict[str, np.ndarray]:
    """A copy of the model's floating-point state."""
    return {k: v.detach().float().cpu().numpy().copy() for k, v in model.state_dict().items()
            if v.is_floating_point()}


def dist_worker(role: str, rank: int, world: int, port: int) -> None:
    """One rank of the dist phase, started by ``phase_dist`` as its own
    process. ``role`` ``gloo``: one of two ranks on the one card, running
    the data-parallel geometry steps from its loader's rows, a
    tensor-parallel step against a data-parallel one (noise off, the same
    global batch), and the sharded eval of the fit checkpoint, unfolded and
    folded, and a ``Trainer`` on a 1x2 mesh with its checkpoint. ``nccl``:
    world size 1 through the backend the port picks for the card, one
    data-parallel step and the sharded eval. Writes
    ``DIST_DIR/<role><rank>.json`` (and ``.npz``)."""
    from mobilenet_yolo_tpu_torch.parallel import initialize_distributed
    from mobilenet_yolo_tpu_torch.parallel.sharding import shard_over_model_axis, split_tensors
    from mobilenet_yolo_tpu_torch.train.checkpoints import state_payload

    t0 = time.perf_counter()
    # the steps in float32, as this process's reference runs them (cuDNN's
    # default is TF32)
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if world > 1:
        check(initialize_distributed(f"localhost:{port}", world, rank, backend="gloo",
                                     device="cuda"), "the gloo ranks joined")
    else:
        # world size 1, which initialize_distributed leaves alone: the
        # backend it would pick for the card
        join_process_group(f"tcp://localhost:{port}", world, rank, device="cuda")
    device = rank_device("cuda")
    data_yaml = str(DATA_DIR / "data.yaml")
    data, cfg = load_yaml(data_yaml), load_config(data_yaml)
    mc = cfg.model
    info = {"role": role, "rank": rank, "backend": torch.distributed.get_backend(),
            "device": str(device)}
    out = {}
    mesh = create_mesh(world, 1)

    def fresh():
        return build_model(mc, device=device, generator=torch.Generator().manual_seed(SEED))

    # the data-parallel geometry steps, each rank on its loader's rows
    modes = DIST_MODES if role == "gloo" else DIST_MODES[:1]
    batches = dist_batches(mc, data, (mesh.data_index, mesh.n_data), len(modes))
    model = fresh()
    state = create_train_state(model)
    steps = {m: make_geometry_train_step(model, mc, fused_aug=m, mesh=mesh) for m in set(modes)}
    for counted in LAUNCH_COUNTERS:
        counted.launches = 0
    losses = []
    for i, (mode, batch) in enumerate(zip(modes, batches)):
        t = batch_to_device(batch, device)
        state, metrics = steps[mode](state, *geometry_args(t), DIST_SEED + i,
                                     out_hw=batch["out_size"])
        losses.append(float(metrics["loss"]))
        if i == 0:
            out.update({f"step1/{k}": v for k, v in state_arrays(model).items()})
    torch.cuda.synchronize()
    info.update(losses=losses, rows=int(batches[0]["gt"].shape[0]),
                step_launches={"aug_compose": aug_compose.launches, "slot_aug": slot_aug.launches})

    if role == "gloo":
        # one tensor-parallel step (mesh 1x2) against a data-parallel one
        # (mesh 2x1) from the same init on the same global batch, noise off
        mesh_tp = create_mesh(1, world)
        full = dist_batches(mc, data, (0, 1), 1)[0]
        full["noise_gate"][:] = False
        t = batch_to_device(full, device)
        results = []
        for grid in (mesh, mesh_tp):
            m = fresh()
            st = create_train_state(m)
            shard_over_model_axis(st, grid)
            step = make_geometry_train_step(m, mc, fused_aug=True, mesh=grid)
            _, metrics = step(st, *global_batch(grid, geometry_args(t)), DIST_SEED,
                              out_hw=full["out_size"])
            results.append((float(metrics["loss"]), state_payload(st)["model"],
                            len(split_tensors(m))))
        (loss_dp, dp, _), (loss_tp, tp, n_split) = results
        info["tp"] = {"loss_dp": loss_dp, "loss_tp": loss_tp, "split_tensors": n_split,
                      "params_max_abs_err": max(float((tp[k] - v).abs().max())
                                                for k, v in dp.items() if v.is_floating_point())}
        # the same two steps with slim_mode loss: under 1x2 every rank's loss
        # carries the whole model's L1 penalty; each rank's penalty after
        # the step, and the gathered model for this process to recompute it
        slim_mc = dict(mc, slim_l1=DIST_SLIM_L1, slim_mode="loss")
        slim = {}
        for name, grid in (("dp", mesh), ("tp", mesh_tp)):
            m = fresh()
            st = create_train_state(m)
            shard_over_model_axis(st, grid)
            step = make_geometry_train_step(m, slim_mc, fused_aug=True, mesh=grid)
            before = aug_compose.launches
            _, metrics = step(st, *global_batch(grid, geometry_args(t)), DIST_SEED,
                              out_hw=full["out_size"])
            torch.cuda.synchronize()
            slim[name] = (float(metrics["loss"]), float(prune.slim_penalty(m)),
                          aug_compose.launches - before, state_payload(st)["model"],
                          split_tensors(m))
        (loss_dp, penalty_dp, launched_dp, dp, _), (loss_tp, penalty_tp, launched_tp, tp,
                                                    split) = slim["dp"], slim["tp"]
        gammas = {prune._gamma_key(site) for site in prune.prunable_gammas(tp)}
        info["tp_slim"] = {"loss_dp": loss_dp, "loss_tp": loss_tp, "penalty_dp": penalty_dp,
                           "penalty_tp": penalty_tp, "launches": [launched_dp, launched_tp],
                           "split_gammas": len(gammas & set(split)),
                           "replicated_gammas": len(gammas - set(split)),
                           "params_max_abs_err": max(float((tp[k] - v).abs().max())
                                                     for k, v in dp.items()
                                                     if v.is_floating_point())}
        out.update({f"tp_slim/{k}": v.float().cpu().numpy() for k, v in tp.items()
                    if v.is_floating_point()})
        info["trainer"] = dist_trainer(mc, cfg, data, mesh_tp, fresh, device, out)

    # the sharded eval of the fit checkpoint, unfolded (kernel 1) and folded
    # (kernels 1-4), every rank reading the whole test set
    raw = CheckpointManager(str(FIT_DIR)).restore_latest_raw()
    served = build_model(mc, device=device)
    served.load_state_dict(served_state_dict(raw))
    test = Loader(DetectionDataset(records.RecordReader(data["test_dataset_path"]["lmdb"]),
                                   phase="test"), mc["batch_size"], [[mc["img_w"], mc["img_h"]]],
                  mc["normalize"]["mean"], mc["normalize"]["std"], shuffle=False,
                  pad_final=False, shard_by_process=False)
    info["eval"] = {}
    for name, net in (("unfolded", served), ("folded", fold_batchnorm(served)))[
            :2 if role == "gloo" else 1]:
        # like with like: unfolded at torch's default precision, as the fit
        # phase's cli.eval it is held to; folded with TF32 off, as the fit
        # phase's in-process folded float32 eval it is held to
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
            defaults if name == "unfolded" else (False, False))
        for counted in LAUNCH_COUNTERS:
            counted.launches = 0
        res = evaluate_detection(make_predict_fn(net, mc, top_k=FIT_TOP_K, mesh=mesh), test,
                                 cfg.classes, float(raw["val_conf"]),
                                 batch_size=mc["batch_size"], device=device, mesh=mesh)
        torch.cuda.synchronize()
        info["eval"][name] = {"mAP": res["mAP"], "new_conf": res["new_conf"],
                              "launches": {k: c.launches for k, c in
                                           (("nms_suppress", suppress), *FUSED.items())}}
    info["seconds"] = time.perf_counter() - t0
    np.savez(DIST_DIR / f"{role}{rank}.npz", **out)
    with open(DIST_DIR / f"{role}{rank}.json", "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()


def dist_trainer(mc: dict, cfg, data: dict, mesh, fresh, device, out: dict) -> dict:
    """A ``Trainer`` on ``mesh`` as ``cli.train --device-geometry`` builds
    it: one epoch of two steps on global batches from the shards, its
    sharded eval and its checkpoint under ``DIST_DIR/trainer``, then a
    second ``Trainer`` resuming it. Puts this rank's model state in ``out``
    (``trainer/<key>``) for this process to hold the checkpoint against."""
    from mobilenet_yolo_tpu_torch.parallel.sharding import split_tensors

    tcfg = TrainerConfig(epochs=1, checkpoint_dir=str(DIST_DIR / "trainer"), eval_every=1,
                         nms_top_k=FIT_TOP_K)

    def make():
        return Trainer(fresh(), mc, cfg.classes, tcfg, mesh=mesh, verbose=False,
                       device_normalize=True, device_geometry=True, device=device)

    test = Loader(DetectionDataset(records.RecordReader(data["test_dataset_path"]["lmdb"]),
                                   phase="test"), mc["batch_size"], [[mc["img_w"], mc["img_h"]]],
                  mc["normalize"]["mean"], mc["normalize"]["std"], shuffle=False,
                  pad_final=False, output_uint8=True, shard_by_process=False)
    batches = dist_batches(mc, data, (mesh.data_index, mesh.n_data), 2)
    trainer = make()
    launches = aug_compose.launches
    mAP = trainer.fit(lambda: batches, lambda: test)
    torch.cuda.synchronize()
    saved = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    out.update({f"trainer/{k}": v.float().cpu().numpy() for k, v in saved.items()
                if v.is_floating_point()})
    resumed = make()
    check(resumed.maybe_resume(), "the second Trainer found the checkpoint")
    got = resumed.model.state_dict()
    split = split_tensors(trainer.model)
    differ = [k for k, v in saved.items() if not torch.equal(got[k], v)]
    return {"mAP": mAP, "steps": aug_compose.launches - launches,
            "resumed_equal": not differ, "differ": differ[:5],
            "differ_split": sum(k in split for k in differ),
            "resumed_epoch": int(resumed.state.epoch),
            "split_tensors": len(split)}


def check_trainer_checkpoint(mc: dict, device) -> dict:
    """The dist phase's ``Trainer`` checkpoint in this one process: it loads
    into the full model with ``strict=True``, and each gloo rank's slice
    of a split tensor (and every unsplit tensor) is its part of it."""
    raw = CheckpointManager(str(DIST_DIR / "trainer")).restore_latest_raw()
    check(raw is not None, "the dist Trainer wrote a checkpoint")
    model = build_model(mc, device=device)
    model.load_state_dict(raw["model"], strict=True)
    full = {k: v.float().cpu().numpy() for k, v in raw["model"].items() if v.is_floating_point()}
    parts = [{k[len("trainer/"):]: v for k, v in np.load(DIST_DIR / f"gloo{r}.npz").items()
              if k.startswith("trainer/")} for r in range(DIST_RANKS)]
    equal, split = True, 0
    for k, v in full.items():
        mine = [p[k] for p in parts]
        if mine[0].shape == v.shape:
            equal &= all(np.array_equal(m, v) for m in mine)
        else:
            split += 1
            equal &= np.array_equal(np.concatenate(mine, axis=0), v)
    return {"parts_equal": bool(equal), "split_tensors": split, "epoch": int(raw["epoch"])}


def step1_arrays(name: str) -> dict[str, np.ndarray]:
    return {k[len("step1/"):]: v for k, v in np.load(DIST_DIR / f"{name}.npz").items()
            if k.startswith("step1/")}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_reference(model, mc: dict, halves: list[list[dict]], device) -> tuple[list, dict]:
    """One process stepping the dist phase's global batches: each rank's
    rows augmented under that rank's seed (``augment_geometry`` with the
    rank's data index), the images joined, and the plain step on them.
    Returns the losses and the state after the first step."""
    state = create_train_state(model)
    step = make_train_step(model, mc, normalize=True)
    losses, first = [], None
    for i, mode in enumerate(DIST_MODES[:len(halves[0])]):
        images, gts, n_gts = [], [], []
        for r, part in enumerate(halves):
            t = batch_to_device(part[i], device)
            images.append(augment_geometry(tuple(t[k] for k in GEOMETRY_BATCH_KEYS),
                                           DIST_SEED + i, part[i]["out_size"], mode,
                                           mesh=types.SimpleNamespace(data_index=r)))
            gts.append(t["gt"])
            n_gts.append(t["n_gt"])
        state, metrics = step(state, *(torch.cat(part) for part in (images, gts, n_gts)))
        losses.append(float(metrics["loss"]))
        if i == 0:
            first = state_arrays(model)
    return losses, first


def step_err(got: dict, want: dict) -> tuple[float, float, str]:
    """The largest parameter difference, and the largest BatchNorm-statistic
    difference on the scale of the layer's activations: a running mean's
    against the running standard deviation, a running variance's against
    the variance (and the layer with it)."""
    params = max(float(np.abs(got[k] - v).max()) for k, v in want.items()
                 if "running" not in k)
    worst = (0.0, "")
    for k, var in want.items():
        if not k.endswith("running_var"):
            continue
        layer = k[:-len("running_var")]
        mean = want[layer + "running_mean"]
        err = max(float((np.abs(got[layer + "running_mean"] - mean) / np.sqrt(var)).max()),
                  float((np.abs(got[k] - var) / var).max()))
        worst = max(worst, (err, layer.rstrip(".")))
    return params, worst[0], worst[1]


def phase_dist(device, smi: str, fit_eval: dict) -> dict:
    """Data and tensor parallelism on the one card (see the module's
    docstring, phase 10). Returns rank 0's launches on the phase's main
    path: kernel 6 and kernel 5 in the data-parallel steps, kernels 1-4 in
    the sharded eval."""
    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    jobs = [("gloo", r, DIST_RANKS) for r in range(DIST_RANKS)] + [("nccl", 0, 1)]
    ports = {"gloo": free_port(), "nccl": free_port()}
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.dist_worker({role!r}, {rank}, {world}, {ports[role]})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for role, rank, world in jobs]
    try:
        # meanwhile, one process steps the same global batches
        data_yaml = str(DATA_DIR / "data.yaml")
        data, cfg = load_yaml(data_yaml), load_config(data_yaml)
        mc = cfg.model
        halves = [dist_batches(mc, data, (r, DIST_RANKS), len(DIST_MODES))
                  for r in range(DIST_RANKS)]
        fresh = functools.partial(build_model, mc, device=device)
        ref_losses, ref_first = dist_reference(
            fresh(generator=torch.Generator().manual_seed(SEED)), mc, halves, device)
        # the fault the BatchNorm check exists for: statistics of one rank's
        # rows alone
        _, alone_first = dist_reference(
            fresh(generator=torch.Generator().manual_seed(SEED)), mc, halves[:1], device)
        whole = dist_batches(mc, data, (0, 1), 1)
        nccl_losses, nccl_first = dist_reference(
            fresh(generator=torch.Generator().manual_seed(SEED)), mc, [whole], device)
        outs = [p.communicate(timeout=DIST_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for (role, rank, _), p, out in zip(jobs, procs, outs):
        check(p.returncode == 0, f"dist {role} rank {rank} exited {p.returncode}:\n{out[-6000:]}")
    infos = {(role, rank): json.load(open(DIST_DIR / f"{role}{rank}.json"))
             for role, rank, _ in jobs}
    gloo = [infos[("gloo", r)] for r in range(DIST_RANKS)]
    nccl = infos[("nccl", 0)]

    # the data-parallel steps against one process
    check(all(g["losses"] == gloo[0]["losses"] for g in gloo), "every gloo rank's losses agree")
    rels = [abs(a - b) / abs(b) for a, b in zip(gloo[0]["losses"], ref_losses)]
    loss_rel, later_rel = rels[0], max(rels[1:])
    params_err, stats_rel, stats_layer = step_err(step1_arrays("gloo0"), ref_first)
    _, alone_stats, alone_layer = step_err(alone_first, ref_first)
    for g in gloo:
        report("dist", what="dp_steps", backend=g["backend"], rank=g["rank"], rows=g["rows"],
               modes="/".join(str(m) for m in DIST_MODES), launches=g["step_launches"],
               losses="/".join(f"{v:.6f}" for v in g["losses"]))
    report("dist", what="dp_vs_one_process", loss_rel=f"{loss_rel:.3g}", tol=DIST_LOSS_RTOL,
           later_loss_max_rel=f"{later_rel:.3g}", later_tol=DIST_LATER_LOSS_RTOL,
           params_max_abs_err=f"{params_err:.3g}", params_tol=DIST_PARAM_ATOL,
           bn_stats_max_rel=f"{stats_rel:.3g}", bn_layer=stats_layer, bn_tol=DIST_BN_TOL,
           one_process_losses="/".join(f"{v:.6f}" for v in ref_losses), card=f"'{smi}'")
    report("dist", what="one_ranks_rows_alone", bn_stats_max_rel=f"{alone_stats:.3g}",
           bn_layer=alone_layer, above_tol=alone_stats > DIST_BN_TOL)
    check(loss_rel <= DIST_LOSS_RTOL and later_rel <= DIST_LATER_LOSS_RTOL,
          f"dp losses vs one process: rel {rels}")
    check(params_err <= DIST_PARAM_ATOL, f"dp params vs one process: {params_err}")
    check(stats_rel <= DIST_BN_TOL < alone_stats,
          f"dp BatchNorm statistics vs one process {stats_rel} <= {DIST_BN_TOL}, which one "
          f"rank's statistics alone ({alone_stats}) exceed")
    for g in gloo:
        want = {"aug_compose": DIST_MODES.count(True), "slot_aug": DIST_MODES.count("split")}
        check(g["step_launches"] == want, f"rank {g['rank']}: {g['step_launches']} == {want}")

    # the tensor-parallel step against the data-parallel one
    tp = gloo[0]["tp"]
    tp_rel = abs(tp["loss_tp"] - tp["loss_dp"]) / abs(tp["loss_dp"])
    report("dist", what="tp_vs_dp", mesh="1x2", loss_dp=f"{tp['loss_dp']:.6f}",
           loss_tp=f"{tp['loss_tp']:.6f}", loss_rel=f"{tp_rel:.3g}", tol=TP_LOSS_RTOL,
           params_max_abs_err=f"{tp['params_max_abs_err']:.3g}", params_tol=TP_PARAM_ATOL,
           split_layers=tp["split_tensors"])
    check(tp["split_tensors"] > 0, "the TP step split layers")
    check(tp_rel <= TP_LOSS_RTOL and tp["params_max_abs_err"] <= TP_PARAM_ATOL,
          f"TP step vs DP step: {tp}")

    # the same with slim_mode loss: the TP step against the DP one, the loss
    # equal on both ranks, each rank's penalty the gathered model's here
    slim = gloo[0]["tp_slim"]
    slim_rel = abs(slim["loss_tp"] - slim["loss_dp"]) / abs(slim["loss_dp"])
    gathered = build_model(mc, device="cpu")
    full = gathered.state_dict()
    full.update({k[len("tp_slim/"):]: torch.from_numpy(v)
                 for k, v in np.load(DIST_DIR / "gloo0.npz").items() if k.startswith("tp_slim/")})
    gathered.load_state_dict(full)
    want_penalty = float(prune.slim_penalty(gathered.double()))
    init_penalty = float(prune.slim_penalty(
        build_model(mc, device="cpu", generator=torch.Generator().manual_seed(SEED)).double()))
    penalty_rel = max(abs(g["tp_slim"]["penalty_tp"] - want_penalty) / want_penalty
                      for g in gloo)
    report("dist", what="tp_slim_loss_vs_dp", mesh="1x2", slim_l1=DIST_SLIM_L1,
           loss_dp=f"{slim['loss_dp']:.6f}", loss_tp=f"{slim['loss_tp']:.6f}",
           loss_rel=f"{slim_rel:.3g}", tol=TP_LOSS_RTOL,
           params_max_abs_err=f"{slim['params_max_abs_err']:.3g}", params_tol=TP_PARAM_ATOL,
           penalty_in_loss=f"{(slim['loss_tp'] - tp['loss_tp']) / DIST_SLIM_L1:.4f}",
           init_penalty=f"{init_penalty:.4f}",
           ranks_penalty="/".join(f"{g['tp_slim']['penalty_tp']:.6f}" for g in gloo),
           gathered_penalty=f"{want_penalty:.6f}", penalty_rel=f"{penalty_rel:.3g}",
           penalty_tol=DIST_PENALTY_RTOL, split_gammas=slim["split_gammas"],
           replicated_gammas=slim["replicated_gammas"], launches=slim["launches"])
    check(slim["split_gammas"] > 0 and slim["replicated_gammas"] > 0,
          f"the TP slim step holds split and replicated gammas: {slim}")
    check(all(g["tp_slim"]["loss_tp"] == slim["loss_tp"] for g in gloo),
          "the TP slim step's loss is equal on every rank")
    check(slim_rel <= TP_LOSS_RTOL and slim["params_max_abs_err"] <= TP_PARAM_ATOL,
          f"TP slim-loss step vs DP: {slim}")
    check(penalty_rel <= DIST_PENALTY_RTOL,
          f"each rank's penalty vs the gathered model's {want_penalty}: {penalty_rel}")
    check(all(g["tp_slim"]["launches"] == [1, 1] for g in gloo),
          "aug_compose once per slim step per rank")

    # the Trainer on the 1x2 mesh, its checkpoint resumed on every rank and
    # loaded here
    ckpt = check_trainer_checkpoint(mc, device)
    for g in gloo:
        tr = g["trainer"]
        report("dist", what="trainer_1x2", rank=g["rank"], steps=tr["steps"],
               mAP=f"{tr['mAP']:.6f}", split_layers=tr["split_tensors"],
               resumed_equal=tr["resumed_equal"], resumed_epoch=tr["resumed_epoch"])
        check(tr["steps"] == 2 and tr["split_tensors"] > 0 and tr["resumed_equal"]
              and tr["resumed_epoch"] == 1, f"rank {g['rank']} Trainer on the 1x2 mesh: {tr}")
    report("dist", what="trainer_checkpoint_one_process", strict_load=True, **ckpt)
    check(ckpt["parts_equal"] and ckpt["split_tensors"] > 0 and ckpt["epoch"] == 1,
          f"the 1x2 Trainer's checkpoint in one process: {ckpt}")
    check(len({g["trainer"]["mAP"] for g in gloo}) == 1, "the Trainer's mAP on every rank")

    # the sharded eval: every rank's mAP bit-equal, near fit's one process
    # on like terms: unfolded against cli.eval (both at torch's defaults),
    # folded against the fit phase's in-process folded float32 eval (both
    # kernels 2-4 with TF32 off)
    n_eval = -(-DATA_TEST // mc["batch_size"])
    for name, fit_key in (("unfolded", "mAP"), ("folded", "folded_f32_mAP")):
        maps = {g["eval"][name]["mAP"] for g in gloo}
        err = abs(gloo[0]["eval"][name]["mAP"] - fit_eval[fit_key])
        for g in gloo:
            report("dist", what=f"sharded_eval_{name}", rank=g["rank"],
                   mAP=f"{g['eval'][name]['mAP']:.6f}", launches=g["eval"][name]["launches"])
            want = {"nms_suppress": n_eval, **{k: n_eval * FUSED_PER_REQUEST[k] * (name == "folded")
                                               for k in FUSED}}
            check(g["eval"][name]["launches"] == want,
                  f"rank {g['rank']} {name} eval launches {g['eval'][name]['launches']} == {want}")
        report("dist", what=f"sharded_eval_{name}_vs_fit",
               against="cli_eval" if name == "unfolded" else "in_process_folded_f32",
               fit_mAP=f"{fit_eval[fit_key]:.6f}", abs_err=f"{err:.3g}", tol=DIST_MAP_TOL,
               margin=f"{DIST_MAP_TOL - err:.3g}", ranks_equal=len(maps) == 1)
        check(len(maps) == 1, f"{name}: every rank's mAP is the same: {maps}")
        check(err <= DIST_MAP_TOL, f"{name} sharded mAP within {DIST_MAP_TOL} of fit's")

    # NCCL at world size 1
    nccl_rel = abs(nccl["losses"][0] - nccl_losses[0]) / abs(nccl_losses[0])
    nccl_params, nccl_stats, _ = step_err(step1_arrays("nccl0"), nccl_first)
    nccl_map_err = abs(nccl["eval"]["unfolded"]["mAP"] - fit_eval["mAP"])
    report("dist", what="nccl_world1", backend=nccl["backend"], loss=f"{nccl['losses'][0]:.6f}",
           loss_rel=f"{nccl_rel:.3g}", params_max_abs_err=f"{nccl_params:.3g}",
           bn_stats_max_rel=f"{nccl_stats:.3g}", launches=nccl["step_launches"],
           mAP=f"{nccl['eval']['unfolded']['mAP']:.6f}", mAP_err=f"{nccl_map_err:.3g}",
           mAP_margin=f"{DIST_MAP_TOL - nccl_map_err:.3g}")
    check(nccl["backend"] == "nccl", "world size 1 on the card picked NCCL")
    check(nccl_rel <= DIST_LOSS_RTOL and nccl_params <= DIST_PARAM_ATOL
          and nccl_stats <= DIST_BN_TOL, "NCCL step vs one process")
    check(nccl_map_err <= DIST_MAP_TOL, "NCCL sharded eval vs fit's mAP")

    launches = {"aug_compose": gloo[0]["step_launches"]["aug_compose"] + sum(slim["launches"]),
                "slot_aug": gloo[0]["step_launches"]["slot_aug"],
                **{k: gloo[0]["eval"]["folded"]["launches"][k] for k in FUSED},
                "nms_suppress": sum(gloo[0]["eval"][n]["launches"]["nms_suppress"]
                                    for n in ("unfolded", "folded"))}
    report("dist", dist_launches=launches,
           worker_seconds="/".join(f"{i['seconds']:.1f}" for i in infos.values()),
           phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=f"'{smi}'")
    return launches


def block_weights(block, dtype) -> list[torch.Tensor]:
    """A folded block's kernel-layout weights at the hidden width it holds
    (the model pads it to a multiple of 8 for the kernels)."""
    w1, b1, wdw, bdw, w2, b2 = mobilenetv2._block_weights(block, dtype)
    ch = block.expand.conv.out_channels
    return [w1[:, :ch].contiguous(), b1[:ch], wdw[..., :ch].contiguous(), bdw[:ch],
            w2[:ch].contiguous(), b2]


@torch.no_grad()
def hold_blocks(what: str, backbone, batch: int, size: int, device, odd_only: bool = False
                ) -> dict:
    """Each fused launch of the folded ``backbone`` at ``batch`` x ``size``,
    on its own weights (unpadded) and seeded activations, against its twin
    in float32 and bf16. Returns the worst error per kernel and dtype."""
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    worst = {}
    for names, kernel, x_shape, ch, cout, residual in block_shapes(backbone, batch, size):
        first = names.split("/")[0]
        if odd_only and (kernel == "fused_stem_block0" or ch % 2 == 0):
            continue
        for dt_name, dtype in DTYPES.items():
            dtype = dtype or torch.float32
            if kernel == "fused_stem_block0":
                weights = list(mobilenetv2._stem_weights(backbone.stem, backbone.block0, dtype))
            else:
                weights = block_weights(getattr(backbone, first), dtype)
            args = [torch.randn(x_shape, generator=gen, device=device).to(dtype), *weights]
            err = rel_err(run_fused(kernel, args, residual), run_fused(kernel, args, residual,
                                                                       twin=True))
            tol = FUSED_F32_REL_TOL if dt_name == "f32" else FUSED_BF16_REL_TOL
            check(err <= tol, f"{what} {names} ({kernel}, Ch {ch}) {dt_name} vs twin "
                              f"{err:.3g} <= {tol}")
            key = f"{kernel}_{dt_name}"
            worst[key] = max(worst.get(key, 0.0), err)
    return worst


def slim_cli(smi: str) -> dict:
    """The slim phase's processes on the data phase's shards: a slim fit
    through the train CLI, ``tools/prune.py`` on the fit phase's plain
    checkpoint and on the slim one (dry runs, then the 30% and 50% cuts),
    the parent and both cuts evaluated by the eval CLI unfine-tuned, the 50%
    cut fine-tuned from its ``params.npz``. Returns what the phase's
    in-process part reads."""
    t0 = time.perf_counter()
    shutil.rmtree(SLIM_DIR, ignore_errors=True)
    SLIM_DIR.mkdir(parents=True)
    data_yaml = str(DATA_DIR / "data.yaml")
    cfg = load_config(data_yaml)
    bs = cfg.model["batch_size"]
    # the slim parent: the fit phase's plain run continued with the prox
    parent = SLIM_DIR / "parent"
    rows, _ = cli_fit("slim", "cli_train_slim", data_yaml, parent, FIT_EPOCHS[-1] + SLIM_EPOCHS,
                   "--resume", str(FIT_DIR), "--slim-l1", SLIM_L1, smi=smi,
                   first=FIT_EPOCHS[-1] + 1)
    raw = CheckpointManager(str(parent)).restore_latest_raw()
    gate = str(raw["val_conf"])

    def prune_cli(checkpoint: Path, *extra: str) -> tuple[str, ...]:
        return ("mobilenet_yolo_tpu_torch.tools.prune", "-y", data_yaml, "-c", str(checkpoint),
                *extra)

    # both dry runs and both cuts at once: each its own process
    checkpoints = {"plain": FIT_DIR, "slim": parent}
    cut_dirs = {ratio: SLIM_DIR / f"cut{round(ratio * 100)}" for ratio in SLIM_CUTS}
    outs = run_modules(*(prune_cli(checkpoint, "--ratio", str(SLIM_CUTS[0]), "--dry-run",
                                   "--out", str(SLIM_DIR / f"dry_{name}"))
                         for name, checkpoint in checkpoints.items()),
                       *(prune_cli(parent, "--ratio", str(ratio), "--out", str(out_dir))
                         for ratio, out_dir in cut_dirs.items()))
    mass = {}
    for name, out in zip(checkpoints, outs):
        check("dry run: nothing written" in out and not (SLIM_DIR / f"dry_{name}").exists(),
              f"prune --dry-run on the {name} checkpoint wrote nothing")
        mass[name] = float(MASS_LINE.search(out).group(1)) / 100.0
    cuts = {ratio: (out_dir, json.loads((out_dir / "summary.json").read_text()))
            for ratio, out_dir in cut_dirs.items()}
    summary = cuts[SLIM_CUTS[0]][1]
    check(abs(summary["gamma_stats"]["bottom_mass_fraction"] - mass["slim"]) <= 1e-4,
          f"the dry run's mass {mass['slim']} is the written summary's {summary['gamma_stats']}")
    report("slim", what="gamma_concentration", cut=SLIM_CUTS[0], plain_bottom_mass=mass["plain"],
           slim_bottom_mass=summary["gamma_stats"]["bottom_mass_fraction"],
           bar=f"< {SLIM_MASS_SHARE} x plain", channels=summary["gamma_stats"]["channels"],
           p10=summary["gamma_stats"]["p10"], median=summary["gamma_stats"]["median"],
           params=f"{summary['params_before']}->{cuts[SLIM_CUTS[1]][1]['params_after']}"
                  f"@{SLIM_CUTS[1]}", card=f"'{smi}'")
    check(summary["gamma_stats"]["bottom_mass_fraction"] < SLIM_MASS_SHARE * mass["plain"],
          f"slim bottom mass {summary['gamma_stats']} < {SLIM_MASS_SHARE} x plain {mass}")

    # the parent and both cuts, unfine-tuned, at the parent's gate; beside
    # them the 50% cut fine-tuned from the prune tool's params.npz
    cut50_dir = cuts[SLIM_CUTS[1]][0]
    ft = SLIM_DIR / "ft50"
    evals = {"parent": (data_yaml, str(parent)),
             **{f"cut{round(ratio * 100)}": (str(out_dir / "data.yaml"),
                                             str(out_dir / "params.npz"))
                for ratio, (out_dir, _) in cuts.items()}}
    with ThreadPoolExecutor(1) as pool:
        fine_tune = pool.submit(cli_fit, "slim", "cli_fine_tune_cut50",
                                str(cut50_dir / "data.yaml"), ft, SLIM_FT_EPOCHS, "--init-from",
                                str(cut50_dir / "params.npz"), smi=smi)
        outs = run_modules(*(("mobilenet_yolo_tpu_torch.cli.eval", "-y", yaml_path, "-c", ck,
                              "--batch-size", str(bs), "--val-conf", gate)
                             for yaml_path, ck in evals.values()))
        ft_rows, _ = fine_tune.result()
    maps = {name: json.loads(out)["mAP"] for name, out in zip(evals, outs)}
    report("slim", what="cuts_unfine_tuned", gate=gate, log_mAP=f"{rows[-1, 2]:.6f}",
           **{f"mAP_{k}": f"{v:.6f}" for k, v in maps.items()},
           bar_cut30=f">= {SLIM_CUT30_SHARE} x parent", card=f"'{smi}'")
    check(maps["cut30"] >= SLIM_CUT30_SHARE * maps["parent"],
          f"the 30% cut's mAP {maps['cut30']:.4f} >= {SLIM_CUT30_SHARE} x {maps['parent']:.4f}")
    report("slim", what="processes", seconds=f"{time.perf_counter() - t0:.1f}", card=f"'{smi}'")
    return {"raw": raw, "cut50_dir": cut50_dir, "ft": ft, "ft_rows": ft_rows}


def phase_slim(device, smi: str, cli: dict | None = None) -> dict:
    """Network Slimming end to end on the data phase's shards: the
    processes of ``slim_cli`` (unless ``cli`` holds their result), then in
    this process the fine-tuned cut served folded (kernels 1-4), a
    ``--round-to 1`` plan of the slim parent served folded (odd hidden
    widths, zero-padded), one fed slim epoch (kernel 6, the prox step), and
    kernels 2-4 against their twins at both plans' widths. Returns the
    launches of the main path."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cli = cli or slim_cli(smi)
    raw, cut50_dir, ft, ft_rows = cli["raw"], cli["cut50_dir"], cli["ft"], cli["ft_rows"]
    data_yaml = str(DATA_DIR / "data.yaml")
    data, cfg = load_yaml(data_yaml), load_config(data_yaml)
    mc, bs = cfg.model, cfg.model["batch_size"]

    # the main path in this process: the fine-tuned cut served folded, the
    # odd-width plan served folded, one fed slim epoch
    for counted in LAUNCH_COUNTERS:
        counted.launches = 0
    cut_cfg = load_config(str(cut50_dir / "data.yaml"))
    mc50 = cut_cfg.model
    raw_ft = CheckpointManager(str(ft)).restore_latest_raw()
    model = build_model(mc50, device=device)
    model.load_state_dict(served_state_dict(raw_ft))
    model.to(memory_format=torch.channels_last)
    folded = fold_batchnorm(model)
    test = Loader(DetectionDataset(records.RecordReader(data["test_dataset_path"]["lmdb"]),
                                   phase="test"), bs, [[mc["img_w"], mc["img_h"]]],
                  mc["normalize"]["mean"], mc["normalize"]["std"], shuffle=False,
                  pad_final=False)
    n_eval = -(-DATA_TEST // bs)
    ft_maps = {}
    for name, (fold, dtype) in FIT_DTYPES.items():
        res = evaluate_detection(make_predict_fn(folded if fold else model, mc50,
                                                 top_k=FIT_TOP_K, dtype=dtype),
                                 test, cut_cfg.classes, float(raw_ft["val_conf"]),
                                 batch_size=bs, device=device)
        ft_maps[name] = res["mAP"]
    torch.cuda.synchronize()
    check(abs(ft_maps["folded_f32"] - ft_maps["f32"]) <= SLIM_FOLD_MAP_TOL,
          f"fine-tuned cut: folded mAP {ft_maps} within {SLIM_FOLD_MAP_TOL} of unfolded")
    hidden = [getattr(model.backbone, f"block{i}").expand.conv.out_channels
              for i in range(1, model.backbone.num_blocks)]
    report("slim", what="fine_tuned_cut50", hidden=hidden, log_mAP=f"{ft_rows[-1, 2]:.6f}",
           val_conf=raw_ft["val_conf"], **{f"mAP_{k}": f"{v:.6f}" for k, v in ft_maps.items()},
           fold_tol=SLIM_FOLD_MAP_TOL, card=f"'{smi}'")

    state = {k: v.detach().cpu() for k, v in served_state_dict(raw).items()}
    keep = prune.plan_prune(state, SLIM_CUTS[1], round_to=1)
    odd_state, odd_plan = prune.apply_prune(state, keep)
    odd_widths = [w for w in odd_plan["backbone_hidden"] if w]
    check(any(w % 2 for w in odd_widths), f"a --round-to 1 plan has odd widths: {odd_widths}")
    odd = build_model(dict(mc, prune=odd_plan), device=device)
    odd.load_state_dict(odd_state)
    odd.eval().to(memory_format=torch.channels_last)
    odd_folded = fold_batchnorm(odd)
    batch = next(iter(test))
    x = torch.from_numpy(batch["images"]).to(device)
    odd_heads = (head_logits(odd_folded, x), head_logits(odd, x))
    odd_err = max(rel_err(odd_heads[0][k], odd_heads[1][k]) for k in HEADS)
    check(odd_err <= FOLD_F32_REL_TOL, f"odd-width plan: folded heads vs unfolded {odd_err:.3g}")
    dets, keep_odd = make_predict_fn(odd_folded, mc, top_k=FIT_TOP_K)(
        x, torch.tensor(float(raw["val_conf"]), device=device))
    check(bool(torch.isfinite(dets).all()), "odd-width plan: detections finite")
    report("slim", what="round_to_1_plan", hidden=odd_plan["backbone_hidden"],
           head=odd_plan.get("backbone_head"), folded_vs_unfolded_f32_rel=f"{odd_err:.3g}",
           tol=FOLD_F32_REL_TOL, kept=int(keep_odd.sum()))

    slim_cfg = dict(mc, slim_l1=float(SLIM_L1), slim_mode="prox")
    parent_model = build_model(mc, device=device)
    parent_model.load_state_dict(served_state_dict(raw))
    trainer = Trainer(parent_model, slim_cfg, cfg.classes,
                      TrainerConfig(checkpoint_dir=str(SLIM_DIR / "in_process"),
                                    nms_top_k=FIT_TOP_K),
                      verbose=False, device_normalize=True, device_geometry=True, device=device)
    fed_epoch("slim", "loader_prox", trainer, mc, data, 0, FIT_EPOCHS[-1] + SLIM_EPOCHS, device,
              smi)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in (("nms_suppress", suppress),
                                                 ("aug_compose", aug_compose), *FUSED.items())}
    # two folded evals, the odd plan's folded heads and its predict
    requests = 2 * n_eval + 2
    want = {name: requests * n for name, n in FUSED_PER_REQUEST.items()}
    check({k: launches[k] for k in FUSED} == want,
          f"slim fused launches {launches} == {want} (17 a folded request)")
    check(launches["nms_suppress"] == len(FIT_DTYPES) * n_eval + 1 and launches["aug_compose"] > 0,
          f"slim: the scan once per eval batch and request, the compose per step: {launches}")

    # kernels 2-4 against their twins at the fine-tuned plan's widths on its
    # own folded weights, and kernels 2-3 at the odd plan's odd widths
    worst = hold_blocks("cut50", folded.backbone, TRAIN_BATCH, SIZE, device)
    worst_odd = hold_blocks("round_to_1", odd_folded.backbone, TRAIN_BATCH, SIZE, device,
                            odd_only=True)
    check(any(k.startswith("fused_inverted_residual") for k in worst_odd),
          f"odd-width blocks went through kernels 2-3: {worst_odd}")
    torch.cuda.synchronize()
    report("slim", what="kernels_vs_twins", batch=TRAIN_BATCH, size=SIZE,
           cut50={k: f"{v:.3g}" for k, v in worst.items()},
           round_to_1_odd={k: f"{v:.3g}" for k, v in worst_odd.items()})

    # b128 folded predict: the fine-tuned cut beside the VOC widths (seeded init)
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    x128 = torch.randn((BATCH, SIZE, SIZE, 3), generator=gen, device=device)
    val_conf = torch.tensor(VAL_CONF, device=device)
    voc = fold_batchnorm(build_model(VOC_CONFIG, device=device,
                                     generator=torch.Generator().manual_seed(SEED))
                         .eval().to(memory_format=torch.channels_last))
    times = {}
    for name, net, net_cfg in (("cut50", folded, mc50), ("voc", voc, VOC_CONFIG)):
        for dt_name, dtype in DTYPES.items():
            f = make_predict_fn(net, net_cfg, dtype=dtype)
            times[f"{name}_{dt_name}_ms"] = f"{cuda_ms(lambda: f(x128, val_conf), iters=MBV3_ITERS):.3f}"
    report("timing", what=f"folded_predict_b{BATCH}", **times, tf32=False, card=f"'{smi}'")
    report("slim", slim_launches=launches, phase_seconds=f"{time.perf_counter() - t_phase:.1f}",
           card=f"'{smi}'")
    return launches


def phase_quant(device, smi: str, fit_eval: dict) -> dict:
    """The fit checkpoint through the port's quantize CLI (its own process):
    calibration on the test shard, the int8 artifact, the float vs int8 mAP
    A/B at the checkpoint's gate; ``mAP_int8`` held to the sanity bar.
    ``mAP_float`` is held like with like: to the same float arm (the folded
    weights on the per-layer modules, batches of ``QUANT_BATCH``) replayed
    in this process at torch's default cuDNN TF32, as the tool runs it; the
    replay with TF32 off to the fit phase's folded float32 eval of the same
    checkpoint at that gate (``fit_eval``). ``cli.eval``'s mAP (unfolded,
    batches of 32, TF32) is printed beside: the two differ in rounding only,
    and on 64 test images that moves the mAP by whole detections. In this
    process the artifact is loaded (``quant.load_int8``) and served through
    ``QuantSim`` on the card, kernel 1 counted, its mAP the tool's; and its
    heads held card vs CPU in float64. Returns the kernels' launches on that
    path."""
    t_phase = time.perf_counter()
    shutil.rmtree(QUANT_DIR, ignore_errors=True)
    QUANT_DIR.mkdir(parents=True)
    data_yaml = str(DATA_DIR / "data.yaml")
    data, cfg = load_yaml(data_yaml), load_config(data_yaml)
    mc = cfg.model
    gate = str(fit_eval["val_conf"])
    artifact = QUANT_DIR / "int8.npz"
    t0 = time.perf_counter()
    out = run_module(
        "mobilenet_yolo_tpu_torch.tools.quantize", "--checkpoint", str(FIT_DIR), "--data-yaml",
        data_yaml, "--out", str(artifact), "--batch-size", str(QUANT_BATCH), "--calib-batches",
        str(QUANT_CALIB_BATCHES), "--eval", "--val-conf", gate)
    rep = json.loads(out[out.index("{"):])  # the report, printed last
    tool_s = time.perf_counter() - t0

    # the float arm replayed here: the tool's model, batches and gate, at
    # TF32 as in the tool's process, then with TF32 off
    test = Loader(DetectionDataset(records.RecordReader(data["test_dataset_path"]["lmdb"]),
                                   phase="test"), QUANT_BATCH, [[mc["img_w"], mc["img_h"]]],
                  mc["normalize"]["mean"], mc["normalize"]["std"], shuffle=False,
                  pad_final=False)
    model = build_model(mc, device=device)
    model.load_state_dict(served_state_dict(CheckpointManager(str(FIT_DIR)).restore_latest_raw()))
    predict = make_predict_fn(quant.per_layer_folded(model), mc, top_k=FIT_TOP_K)
    replay = {}
    for name, tf32 in (("tf32", True), ("f32", False)):
        torch.backends.cudnn.allow_tf32 = tf32
        replay[name] = evaluate_detection(predict, test, cfg.classes, float(gate),
                                          batch_size=QUANT_BATCH, device=device)["mAP"]
    err = abs(rep["mAP_float"] - replay["tf32"])
    f32_err = abs(replay["f32"] - fit_eval["folded_f32_mAP"])
    report("quant", what="ab", seconds=f"{tool_s:.1f}", sites=rep["sites"],
           int8_weights=rep["int8_weights"], total_params=rep["total_params"],
           int8_fraction=rep["int8_fraction"], val_conf=gate,
           mAP_float=f"{rep['mAP_float']:.6f}", replay_tf32_mAP=f"{replay['tf32']:.6f}",
           abs_err=f"{err:.3g}", tol=FIT_EVAL_MAP_TOL, margin=f"{FIT_EVAL_MAP_TOL - err:.3g}",
           replay_f32_mAP=f"{replay['f32']:.6f}",
           fit_folded_f32_mAP=f"{fit_eval['folded_f32_mAP']:.6f}", f32_abs_err=f"{f32_err:.3g}",
           f32_margin=f"{FIT_EVAL_MAP_TOL - f32_err:.3g}", cli_eval_mAP=f"{fit_eval['mAP']:.6f}",
           float_vs_cli_eval=f"{abs(rep['mAP_float'] - fit_eval['mAP']):.3g}",
           mAP_int8=f"{rep['mAP_int8']:.6f}", mAP_drop=f"{rep['mAP_drop']:.6f}",
           predicted_drop=QUANT_PREDICTED_DROP, bar=f"mAP_int8 > {QUANT_MAP_SHARE} x mAP_float",
           card=f"'{smi}'")
    check(err <= FIT_EVAL_MAP_TOL,
          f"the float arm's mAP {rep['mAP_float']} is its replay's {replay['tf32']}")
    check(f32_err <= FIT_EVAL_MAP_TOL,
          f"the float arm's replay with TF32 off {replay['f32']} is the fit phase's folded "
          f"float32 eval's {fit_eval['folded_f32_mAP']}")
    check(rep["mAP_int8"] > QUANT_MAP_SHARE * rep["mAP_float"],
          f"int8 mAP {rep['mAP_int8']} > {QUANT_MAP_SHARE} x float {rep['mAP_float']}")

    # the artifact in this process: the int8 graph served through kernel 1,
    # with PyTorch's default cuDNN TF32 as in the tool's process
    variables, scales = quant.load_int8(str(artifact))
    check(len(scales) == rep["sites"], f"the artifact holds {rep['sites']} activation scales")
    sim = quant.QuantSim(load_flax_variables(build_model(mc, device=device), variables), scales)
    predict = make_predict_fn(sim, mc, top_k=FIT_TOP_K)
    torch.backends.cudnn.allow_tf32 = True
    for counted in LAUNCH_COUNTERS:
        counted.launches = 0
    res = evaluate_detection(predict, test, cfg.classes, float(gate), batch_size=QUANT_BATCH,
                             device=device)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in (("nms_suppress", suppress), *FUSED.items())}
    torch.backends.cudnn.allow_tf32 = False
    n_batches = -(-DATA_TEST // QUANT_BATCH)
    check(launches == {"nms_suppress": n_batches, **{k: 0 for k in FUSED}},
          f"the int8 graph: the scan once a batch, no fused block: {launches}")
    check(abs(res["mAP"] - rep["mAP_int8"]) <= FIT_EVAL_MAP_TOL,
          f"the loaded artifact's int8 mAP {res['mAP']} is the tool's {rep['mAP_int8']}")

    # card vs CPU, float64, the same artifact and images
    x = next(iter(test))["images"][:QUANT_IMAGES].astype(np.float64)
    heads = []
    for dev in (device, torch.device("cpu")):
        model = load_flax_variables(build_model(mc, dtype=torch.float64, device=dev), variables)
        with torch.inference_mode():
            out = quant.QuantSim(model.eval(), scales)(
                torch.from_numpy(x).to(dev).permute(0, 3, 1, 2))
        heads.append({k: out[k].cpu() for k in HEADS})
    f64_err = max(float((heads[0][k] - heads[1][k]).abs().max() / heads[1][k].abs().max())
                  for k in HEADS)
    report("quant", what="artifact", mAP_int8=f"{res['mAP']:.6f}", tool_mAP_int8=rep["mAP_int8"],
           launches=launches, f64_heads_rel_err=f64_err, tol=QUANT_F64_REL_TOL,
           images=QUANT_IMAGES, phase_seconds=f"{time.perf_counter() - t_phase:.1f}",
           card=f"'{smi}'")
    check(f64_err <= QUANT_F64_REL_TOL, f"QuantSim heads card vs CPU, float64: {f64_err}")
    return launches


def op_dispatch_us(device, n: int = 1000) -> dict:
    """Host microseconds a kernel-2 launch at block 2's b1 shape takes
    through the public wrapper (its checks and the registered op), the op
    alone, and the bare ctypes launch that the op's CUDA implementation
    makes, under ``inference_mode`` as ``make_predict_fn`` runs."""
    g = torch.Generator().manual_seed(SEED)
    args = [torch.randn(shape, generator=g).to(device)
            for shape in ((1, 88, 88, 24), (24, 144), (144,), (3, 3, 144), (144,), (144, 24), (24,))]
    calls = {"wrapper": lambda: fb.fused_inverted_residual(*args, residual=True),
             "op": lambda: torch.ops.myt.fused_inverted_residual(*args, True),
             "ctypes": lambda: fb._launch_block(*args, True, 1)}
    out = {}
    with torch.inference_mode():
        for name, call in calls.items():
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            out[f"block_{name}_us"] = f"{(time.perf_counter() - t0) / n * 1e6:.2f}"
            torch.cuda.synchronize()
    return out


@contextlib.contextmanager
def launches_past_the_ops():
    """Kernels 1-4 reached as before they were registered ops: the
    wrappers' checks, then the ops' CUDA implementations (the ctypes
    launch and its counter) called directly, on the predict path."""
    def block(x, w1, b1, wdw, bdw, w2, b2, residual=True):
        fb._check_block("fused_inverted_residual", x, w1, b1, wdw, bdw, w2, b2, even=False)
        return fb._block_s1_cuda(x, w1, b1, wdw, bdw, w2, b2, residual)

    def block_s2(x, w1, b1, wdw, bdw, w2, b2):
        fb._check_block("fused_inverted_residual_s2", x, w1, b1, wdw, bdw, w2, b2, even=True)
        return fb._block_s2_cuda(x, w1, b1, wdw, bdw, w2, b2)

    def scan(over, valid):
        nms_kernel._check(over, valid)
        return nms_kernel._nms_suppress_cuda(over, valid)

    names = ((mobilenetv2, "fused_inverted_residual", block),
             (mobilenetv2, "fused_inverted_residual_s2", block_s2),
             (mobilenetv2, "fused_stem_block0", fb._stem_cuda), (nms_ops, "suppress", scan))
    saved = [getattr(module, name) for module, name, _ in names]
    for module, name, direct in names:
        setattr(module, name, direct)
    try:
        yield
    finally:
        for (module, name, _), op in zip(names, saved):
            setattr(module, name, op)


def op_route_ms(device, rounds: int = 5) -> dict:
    """``bench.py``'s folded bf16 request (its model, input and statistic:
    the best of 2 runs of 32 requests) at b128 and b1, through the ops and
    past them (``launches_past_the_ops``), alternating in this process for
    ``rounds`` rounds; each side's ms a request in round order."""
    out = {}
    model = build_model(bench.BENCH_MODEL_CFG, device=device,
                        generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (BATCH, SIZE, SIZE, 3))
                         .astype(np.float32)).to(device)
    calibrate_bn(model, x)
    predict = make_predict_fn(fold_batchnorm(model), bench.BENCH_MODEL_CFG,
                              dtype=torch.bfloat16)
    val_conf = torch.tensor(bench.VAL_CONF, device=device)
    for batch in (BATCH, 1):
        times = {"op": [], "past_op": []}
        for _ in range(rounds):
            for route, ctx in (("op", contextlib.nullcontext), ("past_op", launches_past_the_ops)):
                with ctx():
                    def run():
                        return predict(x[:batch], val_conf)
                    request_ms(run, device=device, iters=bench.WARMUP)
                    times[route].append(min(request_ms(run, device=device, iters=bench.ITERS)
                                            for _ in range(bench.RUNS)))
        for route, ms in times.items():
            out[f"b{batch}_{route}_ms"] = [round(t, 3) for t in ms]
            out[f"b{batch}_{route}_median_ms"] = round(statistics.median(ms), 3)
    return out


class MytOpLog(TorchDispatchMode):
    """The outputs of every registered ``myt`` op a run calls, in order."""

    def __init__(self):
        super().__init__()
        self.calls: list[tuple[str, object]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if str(func).startswith("myt."):
            self.calls.append((str(func), out))
        return out


def diverging_op(*runs) -> str:
    """The first ``myt`` op whose output differs between two runs (each a
    function of no arguments), or that none does."""
    logs = []
    for run in runs:
        with MytOpLog() as log:
            run()
        torch.cuda.synchronize()
        logs.append(log.calls)
    for i, ((name, a), (other, b)) in enumerate(zip(*logs)):
        if name != other:
            return f"call {i}: {name} in one run, {other} in the other"
        if not torch.equal(a, b):
            err = float((a.double() - b.double()).abs().max()) if a.is_floating_point() else "bool"
            return f"call {i}: {name} differs ({err})"
    return f"no myt op differs ({len(logs[0])} and {len(logs[1])} calls); an aten op does"


def hold_export_plans(eager: dict, x: torch.Tensor, device) -> None:
    """The tile plans of the exported folded program (batch ``len(x)``) held
    to the plain versions, in float32 with TF32 off: each fused kernel
    against its twin on seeded inputs at every block shape of the program,
    and the trained folded heads against the unfolded float32 heads."""
    backbone = eager["folded"].backbone
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    for blocks, kernel, x_shape, ch, cout, residual in block_shapes(backbone, len(x),
                                                                     x.shape[1]):
        args = fused_args(gen, kernel, x_shape, ch, cout, torch.float32, device)
        got = run_fused(kernel, args, residual)
        want = run_fused(kernel, args, residual, twin=True)
        rel = float((got - want).abs().max()) / float(want.abs().max())
        check(rel <= FUSED_F32_REL_TOL,
              f"export: {kernel} {blocks} at {x_shape}: rel err {rel:.3g} <= {FUSED_F32_REL_TOL}")
        report("export", what="plan_vs_twin", blocks=blocks, kernel=kernel, x=tuple(x_shape),
               tile=tile_of(kernel, "f32", x_shape, ch, cout), rel_err=f"{rel:.3g}",
               tol=FUSED_F32_REL_TOL)
    hold_folded_heads("export", "fit", eager["folded"], x, head_logits(eager["unfolded"], x),
                      [("f32", None, FOLD_F32_REL_TOL)])


def phase_export(device, smi: str) -> dict:
    """The fit checkpoint through the port's export CLI (each its own
    process) as ``.pt2`` programs at batch 8, 352x352, unfolded and folded;
    a fresh process (torch and the kernels package alone) loads each and
    serves the 64 test images, counting the kernels; their outputs are held
    to the eager predict in this process, and the b8 tile plans that the
    folded program launches are held to the plain versions: each fused
    kernel against its twin at the program's block shapes, and the folded
    heads against the unfolded float32 heads. The ``--what npz`` export and
    the reference converter's round trip (``--reverse`` of the checkpoint
    directory, then ``--torch``) are served through ``cli/infer.py``'s
    loader with the eager detections. Returns the fresh process's
    launches."""
    t_phase = time.perf_counter()
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    EXPORT_DIR.mkdir(parents=True)
    data_yaml = str(DATA_DIR / "data.yaml")
    data, cfg = load_yaml(data_yaml), load_config(data_yaml)
    mc = cfg.model
    raw = CheckpointManager(str(FIT_DIR)).restore_latest_raw()
    gate = float(raw["val_conf"])
    npz, ref, back = EXPORT_DIR / "params.npz", EXPORT_DIR / "ref.pth.tar", EXPORT_DIR / "ref.npz"

    def export_aot(name: str, *extra: str) -> tuple[str, float, int]:
        path = EXPORT_DIR / f"{name}.pt2"
        t0 = time.perf_counter()
        out = run_module("mobilenet_yolo_tpu_torch.tools.export", "--checkpoint", str(FIT_DIR),
                         "--data-yaml", data_yaml, "--what", "aot", "--out", str(path),
                         "--batch-size", str(EXPORT_BATCH), "--val-conf", str(gate), *extra)
        check("torch.export.load(path).module()(images, val_conf)" in out,
              f"the export tool says how to serve its program: {out[-500:]}")
        return str(path), time.perf_counter() - t0, path.stat().st_size

    # both programs, the npz export and the converter's reverse at once,
    # each its own process (an export's seconds are its process's, beside
    # the others)
    with ThreadPoolExecutor(2) as pool:
        jobs = {name: pool.submit(export_aot, name, *extra)
                for name, extra in (("unfolded", ()), ("folded", ("--fold-bn",)))}
        _, converted = run_modules(
            ("mobilenet_yolo_tpu_torch.tools.export", "--checkpoint", str(FIT_DIR), "--data-yaml",
             data_yaml, "--what", "npz", "--out", str(npz)),
            ("mobilenet_yolo_tpu_torch.tools.convert_torch", "--reverse", "--params",
             str(FIT_DIR), "--out", str(ref)))
        programs = {name: job.result() for name, job in jobs.items()}
    run_module("mobilenet_yolo_tpu_torch.tools.convert_torch", "--torch", str(ref), "--out",
               str(back))

    test = Loader(DetectionDataset(records.RecordReader(data["test_dataset_path"]["lmdb"]),
                                   phase="test"), EXPORT_BATCH, [[mc["img_w"], mc["img_h"]]],
                  mc["normalize"]["mean"], mc["normalize"]["std"], shuffle=False,
                  pad_final=False)
    images = np.concatenate([batch["images"] for batch in test])
    check(images.shape == (DATA_TEST, mc["img_h"], mc["img_w"], 3),
          f"the test images: {images.shape}")
    np.save(EXPORT_DIR / "images.npy", images)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    args = {"images": str(EXPORT_DIR / "images.npy"), "val_conf": gate, "batch": EXPORT_BATCH,
            "iters": EXPORT_ITERS, "programs": {k: v[0] for k, v in programs.items()},
            "out": {k: str(EXPORT_DIR / f"{k}_served.npz") for k in programs}}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SERVE_PT2, json.dumps(args)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT, check=False)
    check(proc.returncode == 0, f"the fresh serving process exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    served = json.loads(proc.stdout.strip().splitlines()[-1])
    serve_s = time.perf_counter() - t0

    model = build_model(mc, device=device)
    model.load_state_dict(served_state_dict(raw))
    eager = {"unfolded": model, "folded": fold_batchnorm(model)}
    x = torch.from_numpy(images).to(device)
    val_conf = torch.tensor(gate, device=device)
    n_batches = -(-DATA_TEST // EXPORT_BATCH)
    launches = {}
    eager_dets = {}
    for name, (path, export_s, size) in programs.items():
        predict = make_predict_fn(eager[name], mc)
        outs = [predict(x[i:i + EXPORT_BATCH], val_conf) for i in range(0, DATA_TEST, EXPORT_BATCH)]
        dets, keep = (torch.cat([o[j] for o in outs]).cpu() for j in (0, 1))
        eager_dets[name] = dets
        got = np.load(args["out"][name])
        keep_equal = bool(np.array_equal(got["keep"], keep.numpy()))
        dets_err = float(np.abs(got["dets"] - dets.numpy()).max())
        if not keep_equal or dets_err > EXPORT_DETS_TOL:
            program = torch.export.load(path).module()
            where = diverging_op(lambda: predict(x[:EXPORT_BATCH], val_conf),
                                 lambda: program(x[:EXPORT_BATCH], val_conf))
            check(False, f"{name}: the loaded program's keep equal {keep_equal}, dets within "
                         f"{dets_err} of eager (tol {EXPORT_DETS_TOL}): {where}")
        want = {k: n_batches * n for k, n in EXPORTED_OPS[name].items()}
        got_launches = {k: n for k, n in served[name]["launches"].items() if n}
        check(got_launches == want, f"{name}: the loaded program launched {got_launches}, "
                                    f"{want} for {n_batches} batches")
        for k, n in served[name]["launches"].items():
            launches[k] = launches.get(k, 0) + n
        eager_ms = cuda_ms(lambda: predict(x[:EXPORT_BATCH], val_conf), iters=EXPORT_ITERS)
        report("export", what=name, export_seconds=f"{export_s:.1f}", pt2_bytes=size,
               load_seconds=f"{served[name]['load_s']:.3f}", launches=got_launches,
               keep_equal=keep_equal, dets_max_abs_err=dets_err, tol=EXPORT_DETS_TOL,
               kept=int(keep.sum()), loaded_b8_ms=f"{served[name]['b8_ms']:.3f}",
               eager_b8_ms=f"{eager_ms:.3f}", predicted=EXPORT_PREDICTED, card=f"'{smi}'")

    hold_export_plans(eager, x[:EXPORT_BATCH], device)
    for name, weights in (("npz", npz), ("converted", back)):
        predict = make_predict_fn(load_variables(build_model(mc, device=device), str(weights)),
                                  mc)
        dets = torch.cat([predict(x[i:i + EXPORT_BATCH], val_conf)[0]
                          for i in range(0, DATA_TEST, EXPORT_BATCH)]).cpu()
        err = float((dets - eager_dets["unfolded"]).abs().max())
        report("export", what=f"{name}_served", weights=weights.name, dets_max_abs_err=err,
               card=f"'{smi}'")
        check(err == 0.0, f"{name}: the served detections equal the checkpoint's ({err})")
    report("export", what="op_dispatch", **op_dispatch_us(device), card=f"'{smi}'")
    report("export", what="op_route_bf16_folded", **op_route_ms(device), card=f"'{smi}'")
    report("export", what="converter", line=converted.strip().splitlines()[0],
           serve_process_seconds=f"{serve_s:.1f}",
           export_launches=launches, phase_seconds=f"{time.perf_counter() - t_phase:.1f}",
           card=f"'{smi}'")
    return launches


def fused_work(kernel: str, x_shape: tuple, ch: int, cout: int, elem: int) -> tuple[int, int]:
    """FLOPs (the expand over every input pixel, as the Pallas kernels do
    it) and bytes (each input and output once) of one fused launch."""
    b, h, w, cin = x_shape
    ho, wo = (h, w) if kernel == "fused_inverted_residual" else (h // 2, w // 2)
    first, first_w = ((ho * wo * 27 * ch, 27 * ch) if kernel == "fused_stem_block0"
                      else (h * w * cin * ch, cin * ch))
    flops = 2 * b * (first + ho * wo * ch * (9 + cout))
    nbytes = elem * (b * h * w * cin + b * ho * wo * cout + first_w + 9 * ch + ch * cout)
    return flops, nbytes + 4 * (2 * ch + cout)


def fused_args(gen: torch.Generator, kernel: str, x_shape: tuple, ch: int, cout: int, dtype,
               device) -> list[torch.Tensor]:
    """Seeded inputs, weights scaled so activations keep unit size."""
    stem = kernel == "fused_stem_block0"
    first, fan_in = ((3, 3, 3, ch), 27) if stem else ((x_shape[3], ch), x_shape[3])

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=device)

    args = [randn(*x_shape), randn(*first, scale=fan_in ** -0.5), randn(ch, scale=0.1),
            randn(3, 3, ch, scale=1 / 3), randn(ch, scale=0.1), randn(ch, cout, scale=ch ** -0.5),
            randn(cout, scale=0.1)]
    return [a.to(dtype) if a.dim() > 1 else a for a in args]


def run_fused(kernel: str, args: list, residual: bool, twin: bool = False) -> torch.Tensor:
    if kernel == "fused_stem_block0":
        return fb.stem_block0_reference(*args) if twin else fb.fused_stem_block0(*args)
    if kernel == "fused_inverted_residual_s2":
        return (fb.inverted_residual_reference(*args, residual=False, stride=2) if twin
                else fb.fused_inverted_residual_s2(*args))
    return (fb.inverted_residual_reference(*args, residual=residual) if twin
            else fb.fused_inverted_residual(*args, residual=residual))


def tile_of(kernel: str, dt_name: str, x_shape: tuple, ch: int, cout: int) -> tuple:
    """The output tile the kernel's wrapper picks for this launch."""
    b, h, w, cin = x_shape
    if kernel == "fused_stem_block0":
        kind = "stem" + ("_bf16" if dt_name == "bf16" else "")
        return fb.pick_tile(kind, h // 2, w // 2, 3, cout, ch, b)
    stride = 2 if kernel == "fused_inverted_residual_s2" else 1
    kind = f"s{stride}" + ("_bf16" if dt_name == "bf16" else "")
    return fb.pick_tile(kind, h // stride, w // stride, cin, cout, ch, b)


def phase_fused_kernels(device) -> tuple[dict, dict, list]:
    """Each fused kernel against its twin at every block shape of the served
    VOC model and of the slim50 plan (batch 128, 352x352), of the published
    BDD model (batch 32, 416x416) and three small ragged cases, float32 and
    bf16, TF32 off. The cases it returns for timing are the VOC and BDD
    models'."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backbone = build_model(VOC_CONFIG, generator=torch.Generator().manual_seed(SEED)).backbone
    shapes = block_shapes(backbone, BATCH, SIZE)
    # slim50's blocks: hidden widths that end the last hidden chunk (48
    # channels in bf16, 24 in float32) part-full; its stem is the VOC one
    slim = build_model(dict(VOC_CONFIG, prune=prune_plan(SLIM50)),
                       generator=torch.Generator().manual_seed(SEED)).backbone
    voc_keys = {tuple(shape[1:]) for shape in shapes}
    slim50 = [(f"slim50:{blocks}", *key) for blocks, *key in block_shapes(slim, BATCH, SIZE)
              if tuple(key) not in voc_keys]
    check(sum(ch % 48 != 0 for _, _, _, ch, _, _ in slim50) >= 8,
          f"slim50's blocks have part-full last chunks: {[s[3] for s in slim50]}")
    # the published BDD model's blocks at its b32 416x416 predict
    bdd = build_model(BDD_SERVE_CONFIG, generator=torch.Generator().manual_seed(SEED)).backbone
    bdd416 = [(f"bdd416:{blocks}", *key)
              for blocks, *key in block_shapes(bdd, BDD_SERVE_BATCH, BDD_SERVE_CONFIG["img_h"])]
    extra = [("unaligned_w11", "fused_inverted_residual", (4, 13, 11, 24), 144, 24, True),
             ("odd_out_w11", "fused_inverted_residual_s2", (4, 22, 22, 16), 96, 24, False),
             ("stem_30x22", "fused_stem_block0", (4, 30, 22, 3), 32, 16, False)]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    worst = {k: 0.0 for k in FUSED}
    worst_bf16 = {k: 0.0 for k in FUSED}  # relative to the largest output
    cases = []
    for blocks, kernel, x_shape, ch, cout, residual in shapes + slim50 + bdd416 + extra:
        for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            args = fused_args(gen, kernel, x_shape, ch, cout, dtype, device)
            got = run_fused(kernel, args, residual)
            want = run_fused(kernel, args, residual, twin=True)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dtype, f"{blocks} {dt_name} output")
            diff = float((got.float() - want.float()).abs().max())
            rel = diff / float(want.float().abs().max())
            tol = FUSED_F32_REL_TOL if dtype == torch.float32 else FUSED_BF16_REL_TOL
            check(rel <= tol, f"{kernel} {blocks} {dt_name}: rel err {rel:.3g} <= {tol}")
            if dtype == torch.float32:
                worst[kernel] = max(worst[kernel], diff)
            else:
                worst_bf16[kernel] = max(worst_bf16[kernel], rel)
            report("fused_kernels", blocks=blocks, kernel=kernel, dtype=dt_name,
                   x=tuple(x_shape), hidden=ch, cout=cout, residual=residual,
                   tile=tile_of(kernel, dt_name, x_shape, ch, cout),
                   max_abs_err=f"{diff:.3g}", rel_err=f"{rel:.3g}", tol=tol)
            del got, want
            if (blocks, kernel, x_shape, ch, cout, residual) in shapes + bdd416:
                cases.append((blocks, kernel, x_shape, ch, cout, dt_name, residual, args))

    # the float32 kernels' three TF32 passes against the float64 twin at
    # block 16's widths (Cin 160, Ch 960, Cout 320) and at the stem's b128
    # 352x352 shape, beside the float32 twin's own error
    for blocks, kernel, x_shape, ch, cout, dt_name, residual, args in cases:
        if dt_name == "f32" and not blocks.startswith("bdd416:") and (
                kernel == "fused_stem_block0" or
                kernel == "fused_inverted_residual" and cout == 320):
            want = run_fused(kernel, [a.double() for a in args], residual, twin=True)
            scale = float(want.abs().max())
            err = float((run_fused(kernel, args, residual).double() - want).abs().max()) / scale
            twin_err = float((run_fused(kernel, args, residual, twin=True).double()
                              - want).abs().max()) / scale
            check(err <= FUSED_F64_REL_TOL,
                  f"{blocks} f32 kernel vs float64 twin: {err:.3g} <= {FUSED_F64_REL_TOL}")
            report("fused_kernels", blocks=blocks, kernel=kernel, dtype="f32", x=tuple(x_shape),
                   vs="float64 twin", rel_err=f"{err:.3g}", f32_twin_rel_err=f"{twin_err:.3g}",
                   tol=FUSED_F64_REL_TOL)
            del want
    return worst, worst_bf16, cases


def hold_folded_heads(phase: str, weights: str, folded, small: torch.Tensor,
                      want: dict, cases) -> None:
    """The folded model's heads against the unfolded float32 heads
    ``want``, in each (dtype name, autocast dtype, tolerance) case."""
    for dt_name, dtype, tol in cases:
        got = head_logits(folded, small, dtype)
        for key in ("out0", "out1"):
            err = rel_err(got[key], want[key])
            check(err <= tol,
                  f"{phase}: {weights} weights, folded {dt_name} vs unfolded f32 {key}: {err:.3g}")
            report(phase, weights=weights, head=key, dtype=dt_name,
                   folded_vs_unfolded_f32_rel=f"{err:.3g}", tol=tol)


def phase_serve_folded(device) -> tuple[dict, dict]:
    """The BatchNorm-folded serving path (``bench.py --fold-bn``'s): the VOC
    model built on the card, folded, served through ``make_predict_fn``;
    the fused kernels' launch counts read around the requests."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 1)
    model = build_model(VOC_CONFIG, generator=torch.Generator().manual_seed(SEED))
    small = torch.from_numpy(rng.normal(0.0, 1.0, (2, SIZE, SIZE, 3)).astype(np.float32)).to(device)
    # the init weights contract, so each comparison sees the rounding of a
    # few layers (check_logits); float32 and bf16 against unfolded float32
    model.eval().to(memory_format=torch.channels_last)
    hold_folded_heads("serve_folded", "init", fold_batchnorm(model), small,
                      head_logits(model, small), INIT_FOLD_CASES)

    calibrate_bn(model, torch.from_numpy(
        rng.normal(0.0, 1.0, (4, SIZE, SIZE, 3)).astype(np.float32)).to(device))
    folded = fold_batchnorm(model)
    predict = {"f32": make_predict_fn(folded, VOC_CONFIG),
               "u8": make_predict_fn(folded, VOC_CONFIG, normalize=True),
               "bf16": make_predict_fn(folded, VOC_CONFIG, dtype=torch.bfloat16)}
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    x128 = torch.randn((BATCH, SIZE, SIZE, 3), generator=gen, device=device)
    u8 = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=gen, device=device,
                       dtype=torch.uint8)
    val_conf = torch.tensor(VAL_CONF, device=device)
    requests = [("f32_b1", "f32", x128[:1].clone()), ("f32_b128", "f32", x128),
                ("u8_b128", "u8", u8), ("bf16_b128", "bf16", x128)]

    # the main path: every request through make_predict_fn on the folded model
    for counted in LAUNCH_COUNTERS:
        counted.launches = 0
    results = {name: predict[mode](images, val_conf) for name, mode, images in requests}
    torch.cuda.synchronize()
    launches = {name: f.launches for name, f in FUSED.items()}
    expected = {name: n * len(requests) for name, n in FUSED_PER_REQUEST.items()}
    check(launches == expected, f"fused launches {launches} == {expected}")
    check(suppress.launches == len(requests), "suppress launched once per folded request")
    report("serve_folded", requests=len(requests), launches=launches,
           suppress_launches=suppress.launches)
    for name, _, images in requests:
        dets, keep = results[name]
        valid = dets[..., 4] > val_conf
        check(dets.shape[:2] == keep.shape and dets.shape[0] == images.shape[0],
              f"{name} output shapes")
        check(bool(torch.isfinite(dets).all()), f"{name} detections finite")
        check(0 < int(keep.sum()) < int(valid.sum()), f"{name}: NMS kept some and cut some")
        report("serve_folded", request=name, kept=int(keep.sum()), valid=int(valid.sum()))

    # the served weights: folded-and-fused heads against the unfolded model
    want, got = head_logits(model, small), head_logits(folded, small)
    for key in ("out0", "out1"):
        err = rel_err(got[key], want[key])
        check(err <= FOLD_F32_REL_TOL, f"served weights, folded vs unfolded f32 {key}: {err:.3g}")
        report("serve_folded", weights="calibrated", head=key, dtype="f32",
               max_abs=f"{float(want[key].abs().max()):.4g}",
               folded_vs_unfolded_rel=f"{err:.3g}", tol=FOLD_F32_REL_TOL)
    return launches, {"model": folded, "predict": predict, "x128": x128, "u8": u8}


def phase_stem_probe(device, smi: str) -> tuple[int, float, dict]:
    """Kernel 7's path: the probe tool, as a user runs it, for each stage
    (its small check and its batch-128 352x352 bench), the launch count
    read around it; then each stage's kernel against its twin at a small
    shape, at S=18 (odd S/2) and at 128x352."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    stem_probe.launches = 0
    runs = {st: probe_stem_cuda.main(["--stage", st, "--bench", "--iters", str(STEM_ITERS)])
            for st in STAGES}
    torch.cuda.synchronize()
    launches = stem_probe.launches
    # check, warmup, timed calls a stage; stage c's bench also times stage a
    expected = len(STAGES) * (1 + 2 + STEM_ITERS) + (2 + STEM_ITERS)
    check(launches == expected, f"stem_probe launches {launches} == {expected}")
    for st, run in runs.items():
        t = run["bench"]
        vs_a = {"vs_stage_a": f"{t['vs_stage_a']:.4f}"} if "vs_stage_a" in t else {}
        report("stem_probe", stage=st, b=t["batch"], s=t["size"], kernel_ms=f"{t['ms']:.4f}",
               plain_ms=f"{t['plain_ms']:.4f}", bound_ms=f"{t['bound_ms']:.4f}",
               bound_by=t["bound_by"], share_of_bound=f"{t['share_of_bound']:.4f}", **vs_a,
               library_ms=t["library_ms"], card=f"'{smi}'")
    report("stem_probe", launches=launches)

    worst = {st: 0.0 for st in STAGES}
    for st in STAGES:
        for b, s in STEM_SHAPES:
            args = probe_stem_cuda.stage_inputs(st, b, s, device, seed=b + s)
            got = stem_probe(args[0], st, *args[1:])
            want = stem_probe_reference(args[0], st, *args[1:])
            torch.cuda.synchronize()
            check(got.shape == want.shape == (b, s // 2, s // 2 * 32), f"stage {st} S={s} shape")
            err = float((got.float() - want.float()).abs().max())
            tol = probe_stem_cuda.tolerance(st, want)
            check(err <= tol, f"stem_probe stage {st} B={b} S={s}: {err} <= {tol}")
            worst[st] = max(worst[st], err)
            report("stem_probe", stage=st, b=b, s=s, max_abs_err=err, tol=f"{tol:.4g}")
            del got, want, args
    return launches, worst["c"], runs["c"]["bench"]


def check_remat_step(device) -> None:
    """One batch-32 352x352 float32 step of the remat model against the
    plain model, same weights and batch: the same loss, the same BatchNorm
    buffers, and every ``num_batches_tracked`` up by one."""
    losses, buffers = {}, {}
    for remat in (False, True):
        model, config, images, gt, n_gt = bench_train.setup(TRAIN_BATCH, SIZE, remat, device)
        state = create_train_state(model)
        _, metrics = make_train_step(model, config)(state, images, gt, n_gt)
        losses[remat] = float(metrics["loss"])
        buffers[remat] = {k: v.clone() for k, v in model.state_dict().items()
                          if "running" in k or "num_batches" in k}
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    check(rel <= REMAT_LOSS_RTOL, f"remat loss {losses[True]} vs plain {losses[False]}: {rel:.3g}")
    diff = max(float((buffers[True][k].double() - v.double()).abs().max())
               for k, v in buffers[False].items())
    check(diff == 0.0, f"remat BN buffers equal the plain model's (max diff {diff:.3g})")
    counts = {int(v) for k, v in buffers[True].items() if k.endswith("num_batches_tracked")}
    check(counts == {1}, f"num_batches_tracked after one remat step: {counts}")
    report("tools", remat_first_loss=f"{losses[True]:.7f}", plain_first_loss=f"{losses[False]:.7f}",
           rel=f"{rel:.3g}", tol=REMAT_LOSS_RTOL, bn_buffers_max_diff=diff,
           num_batches_tracked=sorted(counts))


def phase_tools(device) -> dict:
    """The measurement tools as a user runs them, at reduced iterations:
    ``bench_train`` at batch 32 float32 with and without ``--remat``, the
    remat step against the plain step, ``bench_geometry --stages --fused
    on`` at 416, ``probe_aug_kernels`` and ``probe_stem``; the kernel
    launch counts read around them."""
    for counted in LAUNCH_COUNTERS:
        counted.launches = 0
    for remat in (False, True):
        rec = bench_train.main(["--batch-size", str(TRAIN_BATCH), "--iters", str(TOOLS_ITERS),
                                "--json"] + (["--remat"] if remat else []))
        ratio = rec["bwd_chain_gflops"] / rec["fwd_loss_gflops"]
        check(rec["bwd_delta_ms"] > 0, f"bench_train remat={remat}: bwd_delta_ms > 0")
        check(ratio >= 2.0, f"bench_train remat={remat}: fwd+loss+bwd / fwd+loss FLOPs {ratio}")
        report("tools", bench_train=rec["label"], step_ms=f"{rec['step_ms']:.3f}",
               bwd_delta_ms=f"{rec['bwd_delta_ms']:.3f}", flop_ratio=f"{ratio:.3f}")
    check_remat_step(device)
    geo = bench_geometry.main(["--stages", "--fused", "on", "--img-size", str(TRAIN_SIZES[1]),
                               "--iters", str(TOOLS_ITERS)])
    timed = ("plain_step_ms", "geometry_step_ms", "stage_noise_ms", "stage_total_ms",
             "stage_fused_total_ms")
    check(all(np.isfinite(geo[k]) and geo[k] > 0 for k in timed), f"bench_geometry times {geo}")
    report("tools", bench_geometry=geo["label"], **{k: f"{geo[k]:.3f}" for k in timed})
    aug = probe_aug_kernels.main([])
    stem = probe_stem.main(["--iters", str(TOOLS_ITERS)])
    fold_tol = STEM_FOLD_REL_TOL * stem["a_max_abs"]
    check(max(stem["b_max_abs_diff"], stem["c_max_abs_diff"], stem["d_max_abs_diff"]) <= fold_tol,
          f"probe_stem: the b, c and d folds give formulation a's output within {fold_tol}")
    torch.cuda.synchronize()
    launches = {"slot_aug": slot_aug.launches, "aug_compose": aug_compose.launches}
    check(all(n > 0 for n in launches.values()), f"the tools launched the aug kernels: {launches}")
    report("tools", launches=launches, aug_max_abs_err=aug["aug_compose_max_abs_err"],
           stem_d_max_abs_diff=stem["d_max_abs_diff"])
    return launches


def phase_serve_pruned(device) -> dict:
    """The served slim50 plan (``configs/voc/slim50.yaml``) folded on the
    card. Its hidden widths (176, 232, 312, 224, 216, 152, 80, 264) end the
    block kernels' last hidden chunk part-full (48 channels a chunk in
    bf16, 24 in float32), which no VOC width does. Init weights: the folded
    heads against the unfolded float32 heads, float32 at ``F32_REL_TOL``
    and bf16 at ``BF16_REL_TOL`` (the network contracts, so each sees a few
    layers' rounding, as in ``serve_folded``). Calibrated weights: float32
    at ``FOLD_F32_REL_TOL`` (the bf16 error, amplified ~450-fold like
    float32's, is printed, not held), then a b128 request in each dtype
    through ``make_predict_fn``, the kernels' launch counts read around
    them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(VOC_CONFIG, prune=prune_plan(SLIM50))
    rng = np.random.default_rng(SEED + 4)
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    widths = [getattr(model.backbone, f"block{i}").expand.conv.out_channels
              for i in range(1, model.backbone.num_blocks)]
    ragged = sorted({w for w in widths if w % 48})
    check(len(ragged) >= 8, f"slim50 has ragged hidden widths: {ragged}")
    report("serve_pruned", hidden=widths, head=model.backbone.c5_features, ragged_bf16=ragged)
    small = torch.from_numpy(rng.normal(0.0, 1.0, (2, SIZE, SIZE, 3)).astype(np.float32)).to(device)
    model.eval().to(memory_format=torch.channels_last)
    hold_folded_heads("serve_pruned", "init", fold_batchnorm(model), small,
                      head_logits(model, small), INIT_FOLD_CASES)

    calibrate_bn(model, torch.from_numpy(
        rng.normal(0.0, 1.0, (4, SIZE, SIZE, 3)).astype(np.float32)).to(device))
    model.to(memory_format=torch.channels_last)
    folded = fold_batchnorm(model)
    want = head_logits(model, small)
    hold_folded_heads("serve_pruned", "calibrated", folded, small, want,
                      [("f32", None, FOLD_F32_REL_TOL)])
    got16 = head_logits(folded, small, torch.bfloat16)
    report("serve_pruned", weights="calibrated", dtype="bf16", held=False,
           **{f"{key}_folded_vs_unfolded_f32_rel": f"{rel_err(got16[key], want[key]):.3g}"
              for key in ("out0", "out1")})

    predict = {"f32": make_predict_fn(folded, cfg),
               "bf16": make_predict_fn(folded, cfg, dtype=torch.bfloat16)}
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    x128 = torch.randn((BATCH, SIZE, SIZE, 3), generator=gen, device=device)
    val_conf = torch.tensor(VAL_CONF, device=device)
    # the main path: a b128 request a dtype through make_predict_fn
    for counted in LAUNCH_COUNTERS:
        counted.launches = 0
    results = {mode: f(x128, val_conf) for mode, f in predict.items()}
    torch.cuda.synchronize()
    launches = {name: f.launches for name, f in FUSED.items()}
    expected = {name: n * len(predict) for name, n in FUSED_PER_REQUEST.items()}
    check(launches == expected, f"slim50 fused launches {launches} == {expected}")
    check(suppress.launches == len(predict), "suppress launched once per slim50 request")
    for mode, (dets, keep) in results.items():
        valid = dets[..., 4] > val_conf
        check(bool(torch.isfinite(dets).all()), f"slim50 {mode} detections finite")
        check(0 < int(keep.sum()) < int(valid.sum()), f"slim50 {mode}: NMS kept some and cut some")
        report("serve_pruned", request=f"{mode}_b{BATCH}", kept=int(keep.sum()),
               valid=int(valid.sum()))
    report("serve_pruned", launches=launches, suppress_launches=suppress.launches)
    return {**launches, "nms_suppress": suppress.launches}


def eval_loader(rng: np.random.Generator, images: np.ndarray, dets: torch.Tensor,
                keep: torch.Tensor) -> list[dict]:
    """Loader-style batches of ``EVAL_BATCH`` (the last one ragged) whose
    ground truth is each image's first kept detections, jittered, plus a
    random box, a fifth of the rows marked difficult: the mAP is then
    neither 0 nor 1."""
    n = images.shape[0]
    gt = np.zeros((n, EVAL_GT_ROWS, 5), np.float32)
    n_gt = np.zeros(n, np.int32)
    for i in range(n):
        kept = dets[i][keep[i]].cpu().numpy()[:EVAL_GT_ROWS - 1]
        rows = [[d[6] + 1, (d[0] + d[2]) / 2, (d[1] + d[3]) / 2, d[2] - d[0], d[3] - d[1]]
                for d in kept]
        rows.append([rng.integers(1, 21), *rng.uniform(0.2, 0.8, 2), *rng.uniform(0.05, 0.4, 2)])
        rows = np.asarray(rows, np.float32)
        rows[:, 1:] += rng.normal(0.0, 0.01, rows[:, 1:].shape)
        gt[i, :len(rows)], n_gt[i] = rows, len(rows)
    difficult = (rng.random((n, EVAL_GT_ROWS)) < 0.2).astype(np.float32)
    return [{"images": images[i:i + EVAL_BATCH], "gt": gt[i:i + EVAL_BATCH],
             "n_gt": n_gt[i:i + EVAL_BATCH], "gt_difficult": difficult[i:i + EVAL_BATCH]}
            for i in range(0, n, EVAL_BATCH)]


def phase_eval(device) -> int:
    """``evaluate_detection`` on the card against the same run on the CPU:
    the VOC model with calibrated statistics, in float64 (a calibrated
    random net amplifies float32 rounding ~450-fold, which could reorder
    near-equal scores), ``EVAL_IMAGES`` 352x352 images in batches of
    ``EVAL_BATCH`` with a ragged tail padded on the device, K = 512
    (``cli/eval.py``'s top_k). Each batch's ``keep`` must be equal and the
    mAP within ``EVAL_MAP_TOL``; the scan's launches are read around the
    card's run."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    classes = load_config(default_data_yaml()).classes
    rng = np.random.default_rng(SEED + 5)
    model = build_model(VOC_CONFIG, device="cpu", generator=torch.Generator().manual_seed(SEED))
    calibrate_bn(model, torch.from_numpy(
        rng.normal(0.0, 1.0, (4, SIZE, SIZE, 3)).astype(np.float32)))
    images = rng.normal(0.0, 1.0, (EVAL_IMAGES, SIZE, SIZE, 3))
    f32_predict = make_predict_fn(copy.deepcopy(model).to(device), VOC_CONFIG, top_k=EVAL_TOP_K)
    dets, keep = f32_predict(torch.from_numpy(images.astype(np.float32)).to(device),
                             torch.tensor(VAL_CONF, device=device))
    loader = eval_loader(rng, images, dets, keep)

    keeps = {"card": [], "cpu": []}

    def recorded(side: str, predict):
        def call(batch, val_conf):
            out = predict(batch, val_conf)
            keeps[side].append(out[1].cpu())
            return out
        return call

    card_predict = make_predict_fn(copy.deepcopy(model).double().to(device), VOC_CONFIG,
                                   top_k=EVAL_TOP_K)
    cpu_predict = make_predict_fn(copy.deepcopy(model).double(), VOC_CONFIG, top_k=EVAL_TOP_K)
    # the main path: the evaluator over the loader on the card
    suppress.launches = 0
    card = evaluate_detection(recorded("card", card_predict), loader, classes, VAL_CONF,
                              coco_ap=True, device=device)
    torch.cuda.synchronize()
    launches = suppress.launches
    check(launches == len(loader), f"suppress launched once per eval batch ({launches})")
    cpu = evaluate_detection(recorded("cpu", cpu_predict), loader, classes, VAL_CONF,
                             coco_ap=True, device="cpu")
    check([tuple(k.shape) for k in keeps["card"]] == [(EVAL_BATCH, EVAL_TOP_K)] * len(loader),
          f"eval keep shapes {[tuple(k.shape) for k in keeps['card']]}")
    for i, (got, want) in enumerate(zip(keeps["card"], keeps["cpu"], strict=True)):
        check(torch.equal(got, want), f"eval batch {i}: keep, card == CPU")
    map_err = abs(card["mAP"] - cpu["mAP"])
    check(map_err <= EVAL_MAP_TOL, f"eval mAP card {card['mAP']} vs CPU {cpu['mAP']}")
    check(card["tp"] == cpu["tp"] and card["fp"] == cpu["fp"], "eval TP/FP, card == CPU")
    check(card["new_conf"] == cpu["new_conf"], "eval val_conf controller, card == CPU")
    check(0.0 < card["mAP"] < 1.0, f"eval mAP {card['mAP']} is neither 0 nor 1")
    report("eval", images=EVAL_IMAGES, batches=len(loader), top_k=EVAL_TOP_K, dtype="float64",
           mAP=f"{card['mAP']:.6f}", cpu_mAP=f"{cpu['mAP']:.6f}", map_abs_err=f"{map_err:.3g}",
           tol=EVAL_MAP_TOL, coco_AP=f"{card['coco']['AP']:.6f}", new_conf=card["new_conf"],
           tp=int(sum(card["tp"].values())), fp=int(sum(card["fp"].values())),
           kept=int(sum(int(k.sum()) for k in keeps["card"])), keep_equal=True,
           suppress_launches=launches)
    return launches


def run_module(module: str, *args: str, cwd: Path = ROOT) -> str:
    """``python -m module args`` as a user runs it, from the repository
    root or from ``cwd`` with the repository on ``PYTHONPATH``; fails the
    run on a non-zero exit. Returns its standard output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=SUBPROCESS_TIMEOUT, check=False, env=env)
    check(proc.returncode == 0, f"{module} {' '.join(args)} exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def run_modules(*calls: tuple[str, ...]) -> list[str]:
    """``run_module(*call)`` for each call at once, each its own process
    from the repository root: calls that read none of each other's files.
    Returns their outputs in order; any failure fails the run."""
    with ThreadPoolExecutor(len(calls)) as pool:
        return list(pool.map(lambda call: run_module(*call), calls))


def phase_infer(smi: str) -> None:
    """The infer CLI as its own process on the card, random weights: a
    directory of ``INFER_IMAGES`` seeded PNGs at batch 2 (a padded tail
    batch), then one image; every input gets its ``<name>_result.jpg``."""
    from PIL import Image

    work = ROOT / "build" / "chip_smoke_infer"
    shutil.rmtree(work, ignore_errors=True)
    (work / "images").mkdir(parents=True)
    rng = np.random.default_rng(SEED + 6)
    for i in range(INFER_IMAGES):
        Image.fromarray(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)).save(
            work / "images" / f"im{i}.png")
    common = ("mobilenet_yolo_tpu_torch.cli.infer", "--random-weights", "--val-conf", "0.05")
    out, single = run_modules(
        (*common, "-i", str(work / "images"), "--batch-size", "2", "--out-dir", str(work / "dir")),
        (*common, "-i", str(work / "images" / "im0.png"), "--out-dir", str(work / "single")))
    written = sorted(p.name for p in (work / "dir").iterdir())
    check(written == [f"im{i}_result.jpg" for i in range(INFER_IMAGES)],
          f"infer wrote a result per image: {written}")
    report("infer", mode="directory", results=len(written), line=out.strip().splitlines()[-1],
           card=f"'{smi}'")
    check([p.name for p in (work / "single").iterdir()] == ["im0_result.jpg"],
          "infer wrote the single image's result")
    report("infer", mode="single", results=1, line=single.strip().splitlines()[0],
           card=f"'{smi}'")


def phase_bench(smi: str) -> dict:
    """``python -m mobilenet_yolo_tpu_torch.bench`` as its own process in
    each of ``BENCH_PROCESS_MODES``: one JSON line each with a finite img/s
    and no ``vs_baseline``, printed beside the card."""
    records = {}
    for mode in BENCH_PROCESS_MODES:
        argv = BENCH_MODES[mode]
        lines = run_module("mobilenet_yolo_tpu_torch.bench", *argv).strip().splitlines()
        check(len(lines) == 1, f"bench {mode} printed one line: {lines}")
        rec = json.loads(lines[0])
        check(set(rec) == {"metric", "value", "unit"} and np.isfinite(rec["value"])
              and rec["value"] > 0, f"bench {mode}: {rec}")
        records[mode] = rec
        report("bench", mode=mode, args=" ".join(argv), img_per_s=rec["value"],
               line=lines[0], card=f"'{smi}'")
    return records


def phase_timing(device, smi: str, state: dict) -> dict:
    predict, val_conf = state["predict"], state["val_conf"]
    model, x128 = state["model"], state["x128"]
    fold = state["folded"]
    for mode, images in (("f32", x128), ("bf16", x128), ("u8", state["u8"])):
        ms = cuda_ms(lambda: predict[mode](images, val_conf), iters=20)
        report("timing", what=f"predict_b{BATCH}_{mode}", ms_per_batch=f"{ms:.3f}",
               img_per_s=f"{BATCH * 1000.0 / ms:.1f}", card=f"'{smi}'")
    torch.backends.cudnn.allow_tf32 = True  # cuDNN's default for float32 convs
    ms = cuda_ms(lambda: predict["f32"](x128, val_conf), iters=20)
    torch.backends.cudnn.allow_tf32 = False
    report("timing", what=f"predict_b{BATCH}_f32_tf32", ms_per_batch=f"{ms:.3f}",
           img_per_s=f"{BATCH * 1000.0 / ms:.1f}", card=f"'{smi}'")
    for mode, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        ms = cuda_ms(lambda: head_logits(model, x128, dtype), iters=20)
        report("timing", what=f"forward_only_b{BATCH}_{mode}", ms_per_batch=f"{ms:.3f}",
               card=f"'{smi}'")

    for mode, images in (("f32", x128), ("bf16", x128), ("u8", fold["u8"])):
        ms = cuda_ms(lambda: fold["predict"][mode](images, val_conf), iters=20)
        report("timing", what=f"folded_predict_b{BATCH}_{mode}", ms_per_batch=f"{ms:.3f}",
               img_per_s=f"{BATCH * 1000.0 / ms:.1f}", card=f"'{smi}'")
    for mode, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        ms = cuda_ms(lambda: head_logits(fold["model"], x128, dtype), iters=20)
        report("timing", what=f"folded_forward_only_b{BATCH}_{mode}", ms_per_batch=f"{ms:.3f}",
               card=f"'{smi}'")

    lat = []
    for i in range(60):
        t0 = time.perf_counter()
        predict["f32"](state["x1"], val_conf)
        torch.cuda.synchronize()
        if i >= 10:
            lat.append((time.perf_counter() - t0) * 1000.0)
    lat.sort()
    report("timing", what="predict_b1_f32_latency", median_ms=f"{statistics.median(lat):.3f}",
           p90_ms=f"{lat[int(0.9 * len(lat))]:.3f}", samples=len(lat), card=f"'{smi}'")

    # the bench itself in this process, after every earlier phase (the same
    # model, input and calibration as its own-process run), to set beside
    # its own-process lines
    for mode, argv in BENCH_MODES.items():
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rec = bench.main(argv)
        check(out.getvalue() == json.dumps(rec) + "\n" and np.isfinite(rec["value"])
              and rec["value"] > 0, f"in-process bench {mode}: {out.getvalue()!r}")
        own = state["bench"].get(mode)
        report("timing", what=f"in_process_bench_{mode}", img_per_s=rec["value"],
               own_process_img_per_s=own["value"] if own else "not run", card=f"'{smi}'")

    # the scan at the serving shapes through ``probe_nms``: CUDA events per
    # call of the wrapper (``ms``, as every other kernel; the wrapper's
    # Python sets it at this size), the kernel's device time on one
    # ``over`` (which may sit in L2) and rotating through more than the L2
    # holds (read from HBM), the twin's, the strict triangle's bound (all
    # the scan reads) and the whole matrix's
    times = {}
    for b in (BATCH, 1):
        t = probe_nms.bench(b, 256, 0.05, 100)
        check(t["kernel_ms"] is not None and t["cold_kernel_ms"] is not None,
              f"torch.profiler saw the scan kernel at B={b}")
        report("timing", what=f"suppress_b{b}_k256", kernel_ms=f"{t['events_ms']:.4f}",
               device_ms=f"{t['kernel_ms']:.4f}", cold_device_ms=f"{t['cold_kernel_ms']:.4f}",
               plain_ms=f"{t['plain_ms']:.4f}", bound_ms=f"{t['bound_ms']:.4f}",
               whole_matrix_bound_ms=f"{t['whole_matrix_bound_ms']:.4f}", card=f"'{smi}'")
        if b == BATCH:
            times["nms_suppress"] = {"ms": t["events_ms"], "device_ms": t["kernel_ms"],
                                     "cold_device_ms": t["cold_kernel_ms"],
                                     "plain_ms": t["plain_ms"], "library_ms": None,
                                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                                     "whole_matrix_bound_ms": t["whole_matrix_bound_ms"]}
        else:
            times["nms_suppress"].update(b1_ms=t["events_ms"], b1_device_ms=t["kernel_ms"],
                                         b1_cold_device_ms=t["cold_kernel_ms"],
                                         b1_bound_ms=t["bound_ms"])
    # the evaluator's shape: a batch of EVAL_BATCH at K = 512
    t = probe_nms.bench(EVAL_BATCH, EVAL_TOP_K, 0.05, 100)
    check(t["kernel_ms"] is not None, "torch.profiler saw the scan kernel at K=512")
    report("timing", what=f"suppress_b{EVAL_BATCH}_k{EVAL_TOP_K}",
           kernel_ms=f"{t['events_ms']:.4f}", device_ms=f"{t['kernel_ms']:.4f}",
           cold_device_ms=f"{t['cold_kernel_ms']:.4f}", plain_ms=f"{t['plain_ms']:.4f}",
           bound_ms=f"{t['bound_ms']:.4f}", card=f"'{smi}'")
    times["nms_suppress"].update(k512_b8_ms=t["events_ms"], k512_b8_device_ms=t["kernel_ms"],
                                 k512_b8_cold_device_ms=t["cold_kernel_ms"],
                                 k512_b8_plain_ms=t["plain_ms"], k512_b8_bound_ms=t["bound_ms"])

    size = TRAIN_SIZES[0]
    g = state["batches"][size]
    args = slot_args(g, AUG_SEED)
    kernel_ms = cuda_ms(lambda: slot_aug(*args), iters=20)
    plain_ms = cuda_ms(lambda: slot_aug_reference(*args, dtype=torch.bfloat16), iters=3)
    times["slot_aug"] = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None}
    n_slots = args[0].shape[0]  # u8 slots in, bf16 planar slots out; plans are bytes
    times["slot_aug"]["bound_ms"], times["slot_aug"]["bound_by"] = bound_ms(
        0, n_slots * size * size * 3 * (1 + 2))
    report("timing", what=f"slot_aug_n{TRAIN_BATCH * 4}_s{size}", kernel_ms=f"{kernel_ms:.4f}",
           plain_ms=f"{plain_ms:.4f}", card=f"'{smi}'")
    args = compose_args(g, AUG_SEED)
    kernel_ms = cuda_ms(lambda: aug_compose(*args, (size, size)), iters=20)
    plain_ms = cuda_ms(lambda: aug_compose_reference(*args, (size, size)), iters=3)
    times["aug_compose"] = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None}
    # the active slots' u8 pixels in, the bf16 images out
    active = int(g["active"].sum())
    times["aug_compose"]["bound_ms"], times["aug_compose"]["bound_by"] = bound_ms(
        0, active * size * size * 3 + TRAIN_BATCH * size * size * 3 * 2)
    report("timing", what=f"aug_compose_b{TRAIN_BATCH}_s{size}", kernel_ms=f"{kernel_ms:.4f}",
           plain_ms=f"{plain_ms:.4f}", card=f"'{smi}'")

    for (mode_name, dt_name), (step, train_state) in state["train_runs"].items():
        step_ms = cuda_ms(lambda: step(train_state, *step_args(g, AUG_SEED),
                                       out_hw=(size, size)), iters=5, warmup=1)
        report("timing", what=f"train_step_b{TRAIN_BATCH}_{size}_{mode_name}_{dt_name}",
               ms_per_step=f"{step_ms:.3f}", img_per_s=f"{TRAIN_BATCH * 1000.0 / step_ms:.1f}",
               tf32=False, card=f"'{smi}'")

    # the augmentation kernels' launches apart: the statistics pre-pass
    # (its passes and finish, or PR 6's one block a slot) and the compose
    # or pixel pass, device time per call from torch.profiler
    for stage in TRAIN_SIZES:
        args = compose_args(state["batches"][stage], AUG_SEED)
        by_name = kernel_ms_by_name(lambda: aug_compose(*args, (stage, stage)), 20)
        report("timing", what=f"aug_compose_b{TRAIN_BATCH}_s{stage}_launches",
               prepass_ms=f"{sum(v for k, v in by_name.items() if k != 'compose_kernel'):.4f}",
               **{f"{k}_ms": f"{v:.4f}" for k, v in by_name.items()}, card=f"'{smi}'")
    args = slot_args(g, AUG_SEED)
    by_name = kernel_ms_by_name(lambda: slot_aug(*args), 20)
    prepass = sum(v for k, v in by_name.items() if k != 'slot_apply_kernel')
    report("timing", what=f"slot_aug_n{TRAIN_BATCH * 4}_s{size}_launches",
           prepass_ms=f"{prepass:.4f}", **{f"{k}_ms": f"{v:.4f}" for k, v in by_name.items()},
           card=f"'{smi}'")
    times["slot_aug"].update(prepass_ms=prepass, pixel_pass_ms=by_name.get("slot_apply_kernel"),
                             class_ms={})
    # the pixel pass per slot class: every slot copy-only, noise only, or a
    # hue and a gamma step only (the tool's batch at this stage)
    for traffic in ("copy", "noise", "color"):
        rec = probe_aug_kernels.bench(TRAIN_BATCH, size, 20, traffic)["slot_aug"]
        pixel = rec["kernels_ms"].get("slot_apply_kernel")
        times["slot_aug"]["class_ms"][traffic] = {"ms": rec["ms"], "pixel_pass_ms": pixel}
        report("timing", what=f"slot_aug_n{TRAIN_BATCH * 4}_s{size}_{traffic}",
               ms=f"{rec['ms']:.4f}", pixel_pass_ms="none" if pixel is None else f"{pixel:.4f}",
               card=f"'{smi}'")

    # each fused kernel at every block shape of the folded b128 predict,
    # beside its twin (the cuDNN three-conv chain, channels_last, TF32 off:
    # also the library yardstick) and its bound; bf16 bounds use the bf16
    # tensor-core rate; float32 bounds three TF32 passes at the TF32 rate
    # (every fused kernel's route), with the CUDA-core bound beside them.
    # Sums per predict: the VOC b128 one in float32 under the contract's
    # keys, in bf16 under bf16_*; the BDD b32 416x416 one under bdd416_*
    for name in FUSED:
        times[name] = {"fma_bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0}
    for blocks, kernel, x_shape, ch, cout, dt_name, residual, args in state["fused_cases"]:
        n = len(blocks.split("/"))
        kernel_ms = cuda_ms(lambda: run_fused(kernel, args, residual), iters=10)
        twin_ms = cuda_ms(lambda: run_fused(kernel, args, residual, twin=True), iters=10)
        elem = 4 if dt_name == "f32" else 2
        flops, nbytes = fused_work(kernel, x_shape, ch, cout, elem)
        # three TF32 passes do 3x the operations at the TF32 rate
        ops, rate = (3 * flops, TF32_FLOPS) if dt_name == "f32" else (flops, BF16_FLOPS)
        bound, bound_by = bound_ms(ops, nbytes, rate)
        fma_bound = bound_ms(flops, nbytes, F32_FLOPS)[0]
        # the twin's three convs leave the card idle between launches at
        # the small maps: its kernels' own time from torch.profiler too
        twin_device = profiled_ms(lambda: run_fused(kernel, args, residual, twin=True), 10)
        report("timing", what=f"{kernel}_{blocks}_b{x_shape[0]}_{dt_name}",
               kernel_ms=f"{kernel_ms:.4f}",
               twin_ms=f"{twin_ms:.4f}",
               twin_device_ms="none" if twin_device is None else f"{twin_device:.4f}",
               bound_ms=f"{bound:.4f}", fma_bound_ms=f"{fma_bound:.4f}",
               bound_by=bound_by, gflop=f"{flops / 1e9:.2f}", mb=f"{nbytes / 1e6:.1f}",
               launches_per_predict=n, tile=tile_of(kernel, dt_name, x_shape, ch, cout),
               card=f"'{smi}'")
        t = times[kernel]
        prefix = ("bdd416_" if blocks.startswith("bdd416:") else "") + (
            "" if dt_name == "f32" else "bf16_")
        for key, value in (("ms", kernel_ms), ("plain_ms", twin_ms), ("library_ms", twin_ms),
                           ("bound_ms", bound)):
            t[prefix + key] = t.get(prefix + key, 0.0) + n * value
        # None once the profiler has missed a twin's kernels
        key = prefix + "library_device_ms"
        t[key] = (None if twin_device is None or t.get(key, 0.0) is None
                  else t.get(key, 0.0) + n * twin_device)
        if not prefix:
            t["fma_bound_ms"] += n * fma_bound
            t["ops_ms"] += n * ops / rate * 1e3
            t["bytes_ms"] += n * nbytes / HBM_BYTES_PER_S * 1e3
    for name in FUSED:
        t = times[name]
        t["bound_by"] = "operations" if t.pop("ops_ms") >= t.pop("bytes_ms") else "bytes"
    return times


def phases_fit_bdd(device, smi: str, lap, bdd: bool = True, built=None) -> tuple:
    """The fit phase, then the bdd phase. The bdd phase's processes (its
    tree's build, fit and eval, CPU-bound as the loader feeds them) run
    beside the fit phase's own, which leave the card idle most of the time;
    the fit phase's in-process part waits for them. ``built``: the future
    of ``fabricate_bdd``, if started. Returns both phases' results (the bdd
    phase's None without ``bdd``)."""
    with ThreadPoolExecutor(1) as background:
        job = background.submit(bdd_cli, smi, built) if bdd else None
        fit = phase_fit(device, smi, settle=job.result if bdd else None)
    lap("fit")
    if not bdd:
        return fit, None
    result = phase_bdd(device, smi, job.result())
    lap("bdd")
    return fit, result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=("mbv3", "fit", "bdd", "dist", "hpo", "quant"),
                        nargs="+",
                        help="run only these phases (after the build; mbv3 and fit on freshly "
                             "built VOC shards, dist and quant after fit) and print no kernels "
                             "line or result")
    args = parser.parse_args(argv)
    t_run = t_lap = time.perf_counter()

    def lap(phase: str) -> None:
        """Each phase's wall seconds, the run's so far beside them."""
        nonlocal t_lap
        now = time.perf_counter()
        report("time", step=phase, seconds=f"{now - t_lap:.1f}", total=f"{now - t_run:.1f}")
        t_lap = now

    device, smi = phase_device()
    # both fabricated trees and their shards (processes on the CPU alone)
    # are made beside the build and the first phases
    trees = ThreadPoolExecutor(2)
    voc_built = None if args.only else trees.submit(fabricate_voc)
    bdd_built = None if args.only else trees.submit(fabricate_bdd)
    phase_build()
    lap("build")
    if args.only:
        only = set(args.only)
        if only & {"mbv3", "fit", "dist", "quant"}:
            build_voc_shards(smi)
            lap("voc_shards")
        if "mbv3" in only:
            phase_mbv3(device, smi)
            lap("mbv3")
        if only & {"fit", "dist", "quant"}:
            (_, fit_eval), _ = phases_fit_bdd(device, smi, lap, bdd="bdd" in only)
        elif "bdd" in only:
            phase_bdd(device, smi)
            lap("bdd")
        if "dist" in only:
            phase_dist(device, smi, fit_eval)
            lap("dist")
        if "quant" in only:
            phase_quant(device, smi, fit_eval)
            lap("quant")
        if "hpo" in only:
            if "bdd" not in only:
                build_bdd_shards(smi)
            phase_hpo(device, smi, hpo_cli(smi))
            lap("hpo")
        return
    max_err = {"nms_suppress": phase_kernel(device)}
    launches = {}
    launches["nms_suppress"], state = phase_serve(device)
    aug_errs, batches = phase_aug_kernels(device)
    max_err.update(aug_errs)
    train_launches, state["train_runs"] = phase_train(device, batches)
    launches.update(train_launches)
    state["batches"] = batches
    lap("kernel_serve_aug_train")
    loader_times = phase_data(device, smi, voc_built)
    lap("data")
    mbv3_launches, mbv3_cut_launches = phase_mbv3(device, smi)
    lap("mbv3")
    (fit_launches, fit_eval), bdd_launches = phases_fit_bdd(device, smi, lap, built=bdd_built)
    trees.shutdown()
    # the slim phase's processes (its fits, cuts and evals) and the HPO
    # sweep run beside the dist phase, whose checks are of values, not
    # times; the sweep ends before the slim phase's in-process part
    with ThreadPoolExecutor(2) as background:
        slim = background.submit(slim_cli, smi)
        sweep = background.submit(hpo_cli, smi)
        dist_launches = phase_dist(device, smi, fit_eval)
        lap("dist")
        sweep = sweep.result()
        lap("hpo_processes")
        slim_launches = phase_slim(device, smi, slim.result())
    lap("slim")
    hpo_launches = phase_hpo(device, smi, sweep)
    lap("hpo")
    quant_launches = phase_quant(device, smi, fit_eval)
    lap("quant")
    export_launches = phase_export(device, smi)
    lap("export")
    fused_errs, bf16_errs, state["fused_cases"] = phase_fused_kernels(device)
    max_err.update(fused_errs)
    fused_launches, state["folded"] = phase_serve_folded(device)
    launches.update(fused_launches)
    launches["stem_probe"], max_err["stem_probe"], stem_times = phase_stem_probe(device, smi)
    lap("fused_kernels_serve_folded_stem_probe")
    phase_tools(device)
    pruned_launches = phase_serve_pruned(device)
    eval_launches = phase_eval(device)
    phase_infer(smi)
    lap("tools_serve_pruned_eval_infer")
    state["bench"] = phase_bench(smi)
    lap("bench")
    times = phase_timing(device, smi, state)
    lap("timing")
    times["nms_suppress"].update(eval_launches=eval_launches,
                                 slim50_launches=pruned_launches.pop("nms_suppress"))
    for name in FUSED:
        times[name]["slim50_launches"] = pruned_launches[name]
    times["stem_probe"] = stem_times
    for name, fields in loader_times.items():
        times[name].update(fields)
    for name, n in fit_launches.items():
        times[name]["fit_launches"] = n
    for name in KERNELS:
        times[name]["mbv3_launches"] = mbv3_launches.get(name, 0)
        times[name]["mbv3_cut_launches"] = mbv3_cut_launches.get(name, 0)
        times[name]["slim_launches"] = slim_launches.get(name, 0)
        times[name]["quant_launches"] = quant_launches.get(name, 0)
        times[name]["export_launches"] = export_launches.get(name, 0)
        times[name]["dist_launches"] = dist_launches.get(name, 0)
        times[name]["bdd_launches"] = bdd_launches.get(name, 0)
        times[name]["hpo_launches"] = hpo_launches.get(name, 0)
    for name in FUSED:
        times[name]["bf16_max_rel_err"] = bf16_errs[name]
        times[name]["bf16_source"] = BF16_SOURCES[name]
    bf16_keys = ("bf16_source", "bf16_ms", "bf16_plain_ms", "bf16_library_ms",
                 "bf16_library_device_ms", "bf16_bound_ms", "bf16_max_rel_err")
    bdd416_keys = tuple(f"bdd416_{dt}{key}" for dt in ("", "bf16_")
                        for key in ("ms", "plain_ms", "library_ms", "library_device_ms",
                                    "bound_ms"))
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": max_err[name],
        **{key: times[name][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "library_device_ms", "fma_bound_ms",
                                             "device_ms", "cold_device_ms",
                                             "whole_matrix_bound_ms", "b1_ms", "b1_device_ms",
                                             "b1_cold_device_ms", "b1_bound_ms",
                                             "k512_b8_ms", "k512_b8_device_ms",
                                             "k512_b8_cold_device_ms", "k512_b8_plain_ms",
                                             "k512_b8_bound_ms", "eval_launches",
                                             "slim50_launches",
                                             "prepass_ms", "pixel_pass_ms", "class_ms",
                                             "loader_launches", "loader_max_abs_err",
                                             "loader_buckets", "fit_launches",
                                             "mbv3_launches", "mbv3_cut_launches",
                                             "slim_launches",
                                             "quant_launches", "export_launches",
                                             "dist_launches", "bdd_launches",
                                             "hpo_launches")
           + bf16_keys + bdd416_keys if key in times[name]}}
        for name, (source, replaces) in KERNELS.items()]}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
