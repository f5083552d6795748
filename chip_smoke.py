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
              one epoch (host float32 into ``make_train_step``, uint8 into
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
              step); then MBv3-YOLO through ``cli.train --backbone mbv3``
              (the fit recipe, ``MBV3_EPOCHS`` epochs; the loss ratio held
              to ``MBV3_LOSS_RATIO``, the mAP printed), ``cli.eval`` and
              ``cli.infer``, and one fed epoch in this process (img/s,
              idle share); b128 ms per mode and the b1 latency.
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
              bf16, folded float32 and folded bf16 (kernels 1-4 counted),
              bf16 heads against float32 at ``FIT_BF16_REL_TOL``, the folded bf16
              heads' error printed; one ``Trainer.train_epoch`` fed by
              ``Loader`` and one by ``WorkerLoader(num_workers=4)``, each
              warm at every bucket (img/s, epoch seconds, the card's idle
              share; kernel 6 once per step), and one ``Trainer.evaluate``
              (kernel 1 once per batch).
10. slim    — Network Slimming: ``cli.train --slim-l1 1e-4`` (prox, the fit
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
11. quant    — int8 PTQ of the fit phase's checkpoint: ``python -m
              mobilenet_yolo_tpu_torch.tools.quantize --eval`` as its own
              process (calibration on 4 test batches of 8, the int8
              artifact, the float vs int8 mAP A/B at the checkpoint's gate;
              ``mAP_float`` within ``FIT_EVAL_MAP_TOL`` of the fit phase's
              ``cli.eval`` at that gate,
              ``mAP_int8`` above ``QUANT_MAP_SHARE`` of it, ``mAP_drop``
              beside PERF.md's prediction); in this process the artifact
              (``quant.load_int8``) served through ``QuantSim`` on the
              64 test images (its mAP the tool's, kernel 1 once a batch)
              and its heads card vs CPU in float64 on 4 images
              (``QUANT_F64_REL_TOL``).
12. export   — ``python -m mobilenet_yolo_tpu_torch.tools.export --what
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
13. fused_kernels — the three fused-block kernels of the BatchNorm-folded
              forward (``fused_stem_block0``, ``fused_inverted_residual_s2``,
              ``fused_inverted_residual``; all on the tensor cores, float32
              in three TF32 passes) against their cuDNN twins, TF32 off, in
              float32 and bf16, at the batch-128 352x352 shape of every
              backbone block of the VOC model and of the served slim50 plan
              (hidden widths that end the last 48- and 24-channel chunk
              part-full), an unaligned width and odd output widths; and
              the float32 block kernel (block 16's shape) and stem kernel
              (its b128 352x352 shape) against the float64 twin.
14. serve_folded — the same VOC model folded (``fold_batchnorm``) and served
              through ``make_predict_fn``: batch 1 and 128 at 352x352 in
              float32, uint8 normalize and bf16. Checks each request
              launched the stem kernel once, the stride-2 kernel 4 times and
              the stride-1 kernel 12 times, and that the folded model's
              heads match the unfolded model's (init weights in float32 and
              bf16, served weights in float32).
15. stem_probe — the staged stem roofline kernel (``stem_probe``, stages a,
              b, c) driven through ``python -m
              mobilenet_yolo_tpu_torch.tools.probe_stem_cuda`` as a user runs
              it (a small check and the batch-128 352x352 bench, beside the
              bound, ``share_of_bound``, and for c the ``F.conv2d`` chain and
              ``vs_stage_a``, c's time over a's); checks its launches,
              then each stage against its twin at a small shape, at S=18 (odd
              S/2) and at 128x352.
16. tools   — the measurement tools at reduced iterations: ``bench_train`` at
              batch 32 float32, plain and ``--remat`` (the backward adds time
              and at least doubles the FLOPs), one remat step against the
              plain step (same loss, same BatchNorm buffers, one count each),
              ``bench_geometry --stages --fused on`` at 416,
              ``probe_aug_kernels`` and ``probe_stem``; checks they launched
              the augmentation kernels.
17. serve_pruned — the served slim50 plan (``configs/voc/slim50.yaml``,
              hidden widths off every 48- and 24-channel chunk) folded:
              heads against the unfolded model's (init weights float32 and
              bf16, calibrated float32), then a b128 request a dtype through
              ``make_predict_fn``, the fused kernels' launches counted.
18. eval    — ``evaluate_detection`` on the card against the same run on
              the CPU, float64, 23 images at batch 8 (a ragged tail), K=512:
              ``keep`` equal, mAP within 1e-9; the scan's launches counted.
19. infer   — ``python -m mobilenet_yolo_tpu_torch.cli.infer`` as its own
              process (random weights): a directory of 5 PNGs at batch 2,
              then one image; a result file per input.
20. bench   — ``python -m mobilenet_yolo_tpu_torch.bench`` as its own
              process in 8 modes (``BENCH_MODES``): one JSON line each, a
              finite img/s, printed beside the card.
21. timing  — CUDA-event throughput at batch 128 (f32, bf16, u8), unfolded
              and folded, batch-1 latency, the bench itself in each of its
              modes in this process (``bench.main``: ``in_process_bench_*``,
              beside its own-process number), the train step per mode and
              dtype, and each kernel's time beside its twin's and its bound
              (each fused kernel at every block shape, float32 and bf16;
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
serving process (``quant_launches``, ``export_launches``), and, for
the three fused kernels, the float32 twins' kernels alone per b128 predict
(``library_device_ms``, from
``torch.profiler``) and the float32 bound on CUDA cores (``fma_bound_ms``;
``bound_ms`` is the block kernels' own route, three TF32 passes), their
bf16 sums per b128 predict (``bf16_ms``, ``bf16_plain_ms``,
``bf16_library_ms``; ``bf16_library_device_ms``, the twins' kernels alone
from ``torch.profiler``; ``bf16_bound_ms``) and worst bf16 error relative
to the largest output (``bf16_max_rel_err``).

A ``[time]`` line after each group of phases gives its wall seconds and
the run's so far.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX; yaml is read
through the port's ``config.py`` (the slim50 plan, the VOC class names,
the data yaml) and PIL only to write the infer phase's images and read
the data phase's JPEG sizes. The subprocess phases write under ``build/``
(gitignored).
"""

from __future__ import annotations

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
from mobilenet_yolo_tpu_torch.data.dataset_builder import parse_voc_xml, to_yolo_labels
from mobilenet_yolo_tpu_torch.data.pipeline import DetectionDataset, Loader, batch_to_device
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
from mobilenet_yolo_tpu_torch.tools import (bench_geometry, bench_train, probe_aug_kernels,
                                            probe_nms, probe_stem, probe_stem_cuda)
from mobilenet_yolo_tpu_torch.tools.probe_fused_tiles import block_shapes, kernel_ms as profiled_ms
from mobilenet_yolo_tpu_torch.train import (GEOMETRY_BATCH_KEYS, create_train_state,
                                            make_geometry_train_step, make_train_step,
                                            random_geometry_batch)
from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager, served_state_dict
from mobilenet_yolo_tpu_torch.train.loop import Trainer, TrainerConfig
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
# the bench's modes: each run as its own process
# (python -m mobilenet_yolo_tpu_torch.bench) and through ``bench.main`` in
# this process by ``phase_timing``
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
# 5e-2 lies below the reference's own error; 0.1 is ~1.25x the largest
FIT_BF16_REL_TOL = 0.1
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


def build_voc_shards(smi: str) -> dict:
    """Fabricate the VOC tree and build its shards with the port's
    ``build_dataset`` CLI, each as its own process; check that the native
    record store loaded and that every record's labels read back as the
    tree's XML gives them. Returns the data yaml."""
    from PIL import Image

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "make_fabricated_voc.py"),
                           "--root", str(DATA_DIR), "--train", str(DATA_TRAIN), "--test",
                           str(DATA_TEST), "--seed", str(DATA_SEED)], cwd=ROOT,
                          capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT, check=False)
    check(proc.returncode == 0, f"make_fabricated_voc exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    fabricate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_module("mobilenet_yolo_tpu_torch.cli.build_dataset", "-d", str(DATA_DIR / "data.yaml"))
    build_s = time.perf_counter() - t0
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


def voc_loader(shard: str, mode: str, sizes=None, prefetch: int = DATA_PREFETCH) -> Loader:
    """The VOC training loader over ``shard`` in one of ``LOADER_MODES``."""
    ds_kw, loader_kw = LOADER_MODES[mode]
    ds = DetectionDataset(records.RecordReader(shard), phase="train",
                          expand_scale=VOC_CONFIG["expand_scale"], **ds_kw)
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


def phase_data(device, smi: str) -> dict:
    """The input pipeline from JPEG shards into the training steps on the
    card: the loader alone in each mode, then feeding its step (the
    geometry step in both kernel modes, float32 and bf16), each beside the
    same step on a batch resident on the card; then the two augmentation
    kernels against their twins on a loader batch at each VOC bucket, with
    stale bytes in the inactive slots."""
    t_phase = time.perf_counter()
    data = build_voc_shards(smi)
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
        fed = timed_steps(loader_feed(voc_loader(shard, mode), device), step, state, mode)
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


def phase_fit(device, smi: str) -> dict:
    """Train the full-width MBv2-YOLO with the port's train CLI from the data
    phase's JPEG shards to a real mAP, resume it, serve the checkpoint
    through the eval and infer CLIs, then, in this process, evaluate the
    trained weights in float32, bf16 and folded (kernels 1-4) and time one
    ``Trainer.train_epoch`` fed by ``Loader`` against ``WorkerLoader``
    (kernel 6). Returns the kernels' launches in this process and the eval
    CLI's result at the checkpoint's own gate."""
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
    at_gate = json.loads(run_module("mobilenet_yolo_tpu_torch.cli.eval", "-y", data_yaml, "-c",
                                    str(FIT_DIR), "--val-conf", gate, "--batch-size",
                                    str(mc["batch_size"])))
    err = abs(at_gate["mAP"] - maps[-1])
    own = json.loads(run_module("mobilenet_yolo_tpu_torch.cli.eval", "-y", data_yaml, "-c",
                                str(FIT_DIR), "--batch-size", str(mc["batch_size"])))
    report("fit", what="cli_eval", gate=gate, mAP=f"{at_gate['mAP']:.6f}",
           log_mAP=f"{maps[-1]:.6f}", abs_err=f"{err:.3g}", tol=FIT_EVAL_MAP_TOL,
           own_val_conf=own["val_conf"], own_mAP=f"{own['mAP']:.6f}", card=f"'{smi}'")
    check(err <= FIT_EVAL_MAP_TOL, f"cli/eval mAP {at_gate['mAP']} vs log {maps[-1]}")
    check(own["val_conf"] == raw["val_conf"], "cli/eval restored the run's val_conf")
    first = Path(data["test_dataset_path"]["lists"][0]).read_text().split()[0]
    image = DATA_DIR / "JPEGImages" / f"{first}.jpg"
    out = run_module("mobilenet_yolo_tpu_torch.cli.infer", "-y", data_yaml, "-c", str(FIT_DIR),
                     "-i", str(image), "--out-dir", str(FIT_DIR / "infer"))
    check((FIT_DIR / "infer" / f"{image.stem}_result.jpg").is_file(),
          "cli/infer served the checkpoint and wrote its result")
    report("fit", what="cli_infer", image=image.name, line=out.strip().splitlines()[1],
           card=f"'{smi}'")

    # 4: the trained weights in this process: test mAP per dtype, unfolded
    # and folded, at the checkpoint's gate; the kernels' launches from here on
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
    bf16_err = {k: rel_err(heads["bf16"][k], heads["f32"][k]) for k in ("out0", "out1")}
    folded_bf16_err = {k: rel_err(heads["folded_bf16"][k], heads["folded_f32"][k])
                       for k in ("out0", "out1")}
    report("fit", what="trained_weights", val_conf=raw["val_conf"],
           **{f"mAP_{k}": f"{v:.6f}" for k, v in maps_by.items()},
           bf16_vs_f32_rel=max(bf16_err.values()), tol=FIT_BF16_REL_TOL,
           folded_bf16_vs_folded_f32_rel=max(folded_bf16_err.values()),
           card=f"'{smi}'")
    check(max(bf16_err.values()) <= FIT_BF16_REL_TOL,
          f"trained bf16 heads vs float32 rel err {bf16_err} <= {FIT_BF16_REL_TOL}")

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
    return launches, own


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
            smi: str, first: int = 1) -> np.ndarray:
    """The port's train CLI as its own process from ``ckpt``'s parent
    (TensorBoard events land there) with the fit recipe, to epoch
    ``epochs`` from epoch ``first`` (after a ``--resume``); returns its log."""
    t0 = time.perf_counter()
    out = run_module("mobilenet_yolo_tpu_torch.cli.train", "-y", data_yaml, "-c", str(ckpt),
                     "--epochs", str(epochs), *FIT_RECIPE, *extra, cwd=ckpt.parent)
    rows = read_log(ckpt, epochs, first)
    report(phase, what=what, epochs=epochs, seconds=f"{time.perf_counter() - t0:.1f}",
           loss_first=f"{rows[0, 1]:.6f}", loss_last=f"{rows[-1, 1]:.6f}",
           loss_ratio=f"{rows[-1, 1] / rows[0, 1]:.4f}",
           mAP_by_epoch="/".join(f"{m:.4f}" for m in rows[:, 2]),
           line=out.strip().splitlines()[-1], card=f"'{smi}'")
    return rows


def cli_eval(data_yaml: str, checkpoint: str, batch: int, *extra: str) -> dict:
    return json.loads(run_module("mobilenet_yolo_tpu_torch.cli.eval", "-y", data_yaml, "-c",
                                 checkpoint, "--batch-size", str(batch), *extra))


def phase_mbv3(device, smi: str) -> dict:
    """MobileNetV3-YOLO and MBv3-YOLO MACC-lite on the card at the VOC
    contract: b128 at 352x352 served in float32 and bf16, unfolded and
    folded (the NMS kernel once a request), a CPU float64 slice held against
    the card's; a plain and a geometry step per dtype (``aug_compose`` once
    a geometry step); then MBv3-YOLO trained, evaluated and served through
    the CLIs on the data phase's shards, and one fed epoch in this process.
    Returns the kernels' launches on the phase's main path."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(MBV3_DIR, ignore_errors=True)
    MBV3_DIR.mkdir(parents=True)
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
        models[backbone] = (model, folded)
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

    # the CLIs on the data phase's shards: train, eval, infer
    data_yaml = str(DATA_DIR / "data.yaml")
    data, cfg = load_yaml(data_yaml), load_config(data_yaml)
    mc = cfg.model
    ckpt = MBV3_DIR / "ck"
    rows = cli_fit("mbv3", "cli_train", data_yaml, ckpt, MBV3_EPOCHS, "--backbone", "mbv3",
                   smi=smi)
    ratio = rows[-1, 1] / rows[0, 1]
    check(ratio <= MBV3_LOSS_RATIO, f"mbv3 fit: loss of epoch {MBV3_EPOCHS} / epoch 1 = "
                                    f"{ratio:.4f} <= {MBV3_LOSS_RATIO}")
    ev = cli_eval(data_yaml, str(ckpt), mc["batch_size"], "--backbone", "mbv3")
    first = Path(data["test_dataset_path"]["lists"][0]).read_text().split()[0]
    image = DATA_DIR / "JPEGImages" / f"{first}.jpg"
    out = run_module("mobilenet_yolo_tpu_torch.cli.infer", "--backbone", "mbv3", "-y", data_yaml,
                     "-c", str(ckpt), "-i", str(image), "--out-dir", str(MBV3_DIR / "infer"))
    check((MBV3_DIR / "infer" / f"{image.stem}_result.jpg").is_file(),
          "cli/infer served the MBv3 checkpoint")
    report("mbv3", what="cli", loss_ratio=f"{ratio:.4f}", bar_ratio=MBV3_LOSS_RATIO,
           log_mAP=f"{rows[-1, 2]:.6f}", eval_mAP=f"{ev['mAP']:.6f}", val_conf=ev["val_conf"],
           held_mAP=False, infer=out.strip().splitlines()[1], card=f"'{smi}'")

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
    launches = {"nms_suppress": suppress.launches, "aug_compose": aug_compose.launches}

    # timing: b128 per mode, b1 latency (CUDA events, TF32 off)
    for backbone, (model, folded) in models.items():
        times = {}
        for name, (fold, dtype) in MBV3_DTYPES.items():
            f = make_predict_fn(folded if fold else model, VOC_CONFIG, dtype=dtype)
            times[f"b{BATCH}_{name}_ms"] = f"{cuda_ms(lambda: f(x128, val_conf), iters=MBV3_ITERS):.3f}"
        f = make_predict_fn(model, VOC_CONFIG)
        times["b1_f32_ms"] = f"{cuda_ms(lambda: f(x128[:1], val_conf), iters=20):.3f}"
        report("timing", what=f"{backbone}_predict", **times, tf32=False, card=f"'{smi}'")
    report("mbv3", mbv3_launches=launches, phase_seconds=f"{time.perf_counter() - t_phase:.1f}",
           card=f"'{smi}'")
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


def phase_slim(device, smi: str) -> dict:
    """Network Slimming end to end on the data phase's shards: a slim fit
    through the train CLI, ``tools/prune.py`` on the fit phase's plain
    checkpoint and on the slim one (dry runs, then the 30% and 50% cuts),
    the parent and both cuts evaluated by the eval CLI unfine-tuned, the 50%
    cut fine-tuned from its ``params.npz``; then in this process the
    fine-tuned cut served folded (kernels 1-4), a ``--round-to 1`` plan of
    the slim parent served folded (odd hidden widths, zero-padded), one
    fed slim epoch (kernel 6, the prox step), and kernels 2-4 against their
    twins at both plans' widths. Returns the launches of the main path."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(SLIM_DIR, ignore_errors=True)
    SLIM_DIR.mkdir(parents=True)
    data_yaml = str(DATA_DIR / "data.yaml")
    data, cfg = load_yaml(data_yaml), load_config(data_yaml)
    mc, bs = cfg.model, cfg.model["batch_size"]
    # the slim parent: the fit phase's plain run continued with the prox
    parent = SLIM_DIR / "parent"
    rows = cli_fit("slim", "cli_train_slim", data_yaml, parent, FIT_EPOCHS[-1] + SLIM_EPOCHS,
                   "--resume", str(FIT_DIR), "--slim-l1", SLIM_L1, smi=smi,
                   first=FIT_EPOCHS[-1] + 1)
    raw = CheckpointManager(str(parent)).restore_latest_raw()
    gate = str(raw["val_conf"])

    def prune_cli(checkpoint: Path, *extra: str) -> str:
        return run_module("mobilenet_yolo_tpu_torch.tools.prune", "-y", data_yaml, "-c",
                          str(checkpoint), *extra)

    mass = {}
    for name, checkpoint in (("plain", FIT_DIR), ("slim", parent)):
        out = prune_cli(checkpoint, "--ratio", str(SLIM_CUTS[0]), "--dry-run", "--out",
                        str(SLIM_DIR / "dry"))
        check("dry run: nothing written" in out and not (SLIM_DIR / "dry").exists(),
              f"prune --dry-run on the {name} checkpoint wrote nothing")
        mass[name] = float(MASS_LINE.search(out).group(1)) / 100.0
    cuts = {}
    for ratio in SLIM_CUTS:
        out_dir = SLIM_DIR / f"cut{round(ratio * 100)}"
        prune_cli(parent, "--ratio", str(ratio), "--out", str(out_dir))
        cuts[ratio] = (out_dir, json.loads((out_dir / "summary.json").read_text()))
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

    # the parent and both cuts, unfine-tuned, at the parent's gate
    maps = {"parent": cli_eval(data_yaml, str(parent), bs, "--val-conf", gate)["mAP"]}
    for ratio, (out_dir, _) in cuts.items():
        maps[f"cut{round(ratio * 100)}"] = cli_eval(str(out_dir / "data.yaml"),
                                                    str(out_dir / "params.npz"), bs,
                                                    "--val-conf", gate)["mAP"]
    report("slim", what="cuts_unfine_tuned", gate=gate, log_mAP=f"{rows[-1, 2]:.6f}",
           **{f"mAP_{k}": f"{v:.6f}" for k, v in maps.items()},
           bar_cut30=f">= {SLIM_CUT30_SHARE} x parent", card=f"'{smi}'")
    check(maps["cut30"] >= SLIM_CUT30_SHARE * maps["parent"],
          f"the 30% cut's mAP {maps['cut30']:.4f} >= {SLIM_CUT30_SHARE} x {maps['parent']:.4f}")

    # the 50% cut fine-tuned from the prune tool's params.npz
    cut50_dir = cuts[SLIM_CUTS[1]][0]
    ft = SLIM_DIR / "ft50"
    ft_rows = cli_fit("slim", "cli_fine_tune_cut50", str(cut50_dir / "data.yaml"), ft,
                      SLIM_FT_EPOCHS, "--init-from", str(cut50_dir / "params.npz"), smi=smi)

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
    A/B at the checkpoint's gate; ``mAP_float`` held to the fit phase's
    ``cli.eval`` of the same checkpoint at that gate (``fit_eval``),
    ``mAP_int8`` to the sanity bar. In this process the artifact is loaded
    (``quant.load_int8``) and served through ``QuantSim`` on the card, kernel
    1 counted, its mAP the tool's; and its heads held card vs CPU in
    float64. Returns the kernels' launches on that path."""
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
    evaluated = fit_eval
    report("quant", what="ab", seconds=f"{tool_s:.1f}", sites=rep["sites"],
           int8_weights=rep["int8_weights"], total_params=rep["total_params"],
           int8_fraction=rep["int8_fraction"], val_conf=gate,
           mAP_float=f"{rep['mAP_float']:.6f}", cli_eval_mAP=f"{evaluated['mAP']:.6f}",
           mAP_int8=f"{rep['mAP_int8']:.6f}", mAP_drop=f"{rep['mAP_drop']:.6f}",
           predicted_drop=QUANT_PREDICTED_DROP, bar=f"mAP_int8 > {QUANT_MAP_SHARE} x mAP_float",
           card=f"'{smi}'")
    check(abs(rep["mAP_float"] - evaluated["mAP"]) <= FIT_EVAL_MAP_TOL,
          f"the float arm's mAP {rep['mAP_float']} is cli.eval's {evaluated['mAP']}")
    check(rep["mAP_int8"] > QUANT_MAP_SHARE * rep["mAP_float"],
          f"int8 mAP {rep['mAP_int8']} > {QUANT_MAP_SHARE} x float {rep['mAP_float']}")

    # the artifact in this process: the int8 graph served through kernel 1,
    # with PyTorch's default cuDNN TF32 as in the tool's process
    variables, scales = quant.load_int8(str(artifact))
    check(len(scales) == rep["sites"], f"the artifact holds {rep['sites']} activation scales")
    sim = quant.QuantSim(load_flax_variables(build_model(mc, device=device), variables), scales)
    test = Loader(DetectionDataset(records.RecordReader(data["test_dataset_path"]["lmdb"]),
                                   phase="test"), QUANT_BATCH, [[mc["img_w"], mc["img_h"]]],
                  mc["normalize"]["mean"], mc["normalize"]["std"], shuffle=False,
                  pad_final=False)
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
    programs = {}
    for name, extra in (("unfolded", ()), ("folded", ("--fold-bn",))):
        path = EXPORT_DIR / f"{name}.pt2"
        t0 = time.perf_counter()
        out = run_module("mobilenet_yolo_tpu_torch.tools.export", "--checkpoint", str(FIT_DIR),
                         "--data-yaml", data_yaml, "--what", "aot", "--out", str(path),
                         "--batch-size", str(EXPORT_BATCH), "--val-conf", str(gate), *extra)
        check("torch.export.load(path).module()(images, val_conf)" in out,
              f"the export tool says how to serve its program: {out[-500:]}")
        programs[name] = (str(path), time.perf_counter() - t0, path.stat().st_size)
    # the npz export and the converter's round trip, each its own process
    npz, ref, back = EXPORT_DIR / "params.npz", EXPORT_DIR / "ref.pth.tar", EXPORT_DIR / "ref.npz"
    run_module("mobilenet_yolo_tpu_torch.tools.export", "--checkpoint", str(FIT_DIR),
               "--data-yaml", data_yaml, "--what", "npz", "--out", str(npz))
    converted = run_module("mobilenet_yolo_tpu_torch.tools.convert_torch", "--reverse",
                           "--params", str(FIT_DIR), "--out", str(ref))
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
    VOC model and of the slim50 plan (batch 128, 352x352) and three small
    ragged cases, float32 and bf16, TF32 off. The cases it returns for
    timing are the VOC model's."""
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
    extra = [("unaligned_w11", "fused_inverted_residual", (4, 13, 11, 24), 144, 24, True),
             ("odd_out_w11", "fused_inverted_residual_s2", (4, 22, 22, 16), 96, 24, False),
             ("stem_30x22", "fused_stem_block0", (4, 30, 22, 3), 32, 16, False)]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    worst = {k: 0.0 for k in FUSED}
    worst_bf16 = {k: 0.0 for k in FUSED}  # relative to the largest output
    cases = []
    for blocks, kernel, x_shape, ch, cout, residual in shapes + slim50 + extra:
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
            if (blocks, kernel, x_shape, ch, cout, residual) in shapes:
                cases.append((blocks, kernel, x_shape, ch, cout, dt_name, residual, args))

    # the float32 kernels' three TF32 passes against the float64 twin at
    # block 16's widths (Cin 160, Ch 960, Cout 320) and at the stem's b128
    # 352x352 shape, beside the float32 twin's own error
    for blocks, kernel, x_shape, ch, cout, dt_name, residual, args in cases:
        if dt_name == "f32" and (kernel == "fused_stem_block0" or
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
    common = ("--random-weights", "--val-conf", "0.05")
    out = run_module("mobilenet_yolo_tpu_torch.cli.infer", *common, "-i", str(work / "images"),
                     "--batch-size", "2", "--out-dir", str(work / "dir"))
    written = sorted(p.name for p in (work / "dir").iterdir())
    check(written == [f"im{i}_result.jpg" for i in range(INFER_IMAGES)],
          f"infer wrote a result per image: {written}")
    report("infer", mode="directory", results=len(written), line=out.strip().splitlines()[-1],
           card=f"'{smi}'")
    out = run_module("mobilenet_yolo_tpu_torch.cli.infer", *common, "-i",
                     str(work / "images" / "im0.png"), "--out-dir", str(work / "single"))
    check([p.name for p in (work / "single").iterdir()] == ["im0_result.jpg"],
          "infer wrote the single image's result")
    report("infer", mode="single", results=1, line=out.strip().splitlines()[0], card=f"'{smi}'")


def phase_bench(smi: str) -> dict:
    """``python -m mobilenet_yolo_tpu_torch.bench`` as its own process in
    each of ``BENCH_MODES``: one JSON line each with a finite img/s and no
    ``vs_baseline``, printed beside the card."""
    records = {}
    for mode, argv in BENCH_MODES.items():
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
        report("timing", what=f"in_process_bench_{mode}", img_per_s=rec["value"],
               own_process_img_per_s=state["bench"][mode]["value"], card=f"'{smi}'")

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
    # Sums per predict: float32 under the contract's keys, bf16 under bf16_*
    for name in FUSED:
        times[name] = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "library_device_ms": 0.0, "bound_ms": 0.0, "fma_bound_ms": 0.0,
                       "ops_ms": 0.0, "bytes_ms": 0.0, "bf16_ms": 0.0, "bf16_plain_ms": 0.0,
                       "bf16_library_ms": 0.0, "bf16_library_device_ms": 0.0,
                       "bf16_bound_ms": 0.0}
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
        report("timing", what=f"{kernel}_{blocks}_b{BATCH}_{dt_name}", kernel_ms=f"{kernel_ms:.4f}",
               twin_ms=f"{twin_ms:.4f}",
               twin_device_ms="none" if twin_device is None else f"{twin_device:.4f}",
               bound_ms=f"{bound:.4f}", fma_bound_ms=f"{fma_bound:.4f}",
               bound_by=bound_by, gflop=f"{flops / 1e9:.2f}", mb=f"{nbytes / 1e6:.1f}",
               launches_per_predict=n, tile=tile_of(kernel, dt_name, x_shape, ch, cout),
               card=f"'{smi}'")
        t = times[kernel]
        if dt_name == "f32":  # the JSON line: time per b128 predict
            t["ms"] += n * kernel_ms
            t["plain_ms"] += n * twin_ms
            t["library_ms"] += n * twin_ms
            # None once the profiler has missed a twin's kernels
            if twin_device is None or t["library_device_ms"] is None:
                t["library_device_ms"] = None
            else:
                t["library_device_ms"] += n * twin_device
            t["bound_ms"] += n * bound
            t["fma_bound_ms"] += n * fma_bound
            t["ops_ms"] += n * ops / rate * 1e3
            t["bytes_ms"] += n * nbytes / HBM_BYTES_PER_S * 1e3
        else:
            t["bf16_ms"] += n * kernel_ms
            t["bf16_plain_ms"] += n * twin_ms
            t["bf16_library_ms"] += n * twin_ms
            # None once the profiler has missed a twin's kernels
            if twin_device is None or t["bf16_library_device_ms"] is None:
                t["bf16_library_device_ms"] = None
            else:
                t["bf16_library_device_ms"] += n * twin_device
            t["bf16_bound_ms"] += n * bound
    for name in FUSED:
        t = times[name]
        t["bound_by"] = "operations" if t.pop("ops_ms") >= t.pop("bytes_ms") else "bytes"
    return times


def main() -> None:
    t_run = t_lap = time.perf_counter()

    def lap(phase: str) -> None:
        """Each phase's wall seconds, the run's so far beside them."""
        nonlocal t_lap
        now = time.perf_counter()
        report("time", step=phase, seconds=f"{now - t_lap:.1f}", total=f"{now - t_run:.1f}")
        t_lap = now

    device, smi = phase_device()
    phase_build()
    lap("build")
    max_err = {"nms_suppress": phase_kernel(device)}
    launches = {}
    launches["nms_suppress"], state = phase_serve(device)
    aug_errs, batches = phase_aug_kernels(device)
    max_err.update(aug_errs)
    train_launches, state["train_runs"] = phase_train(device, batches)
    launches.update(train_launches)
    state["batches"] = batches
    lap("kernel_serve_aug_train")
    loader_times = phase_data(device, smi)
    lap("data")
    mbv3_launches = phase_mbv3(device, smi)
    lap("mbv3")
    fit_launches, fit_eval = phase_fit(device, smi)
    lap("fit")
    slim_launches = phase_slim(device, smi)
    lap("slim")
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
        times[name]["slim_launches"] = slim_launches.get(name, 0)
        times[name]["quant_launches"] = quant_launches.get(name, 0)
        times[name]["export_launches"] = export_launches.get(name, 0)
    for name in FUSED:
        times[name]["bf16_max_rel_err"] = bf16_errs[name]
        times[name]["bf16_source"] = BF16_SOURCES[name]
    bf16_keys = ("bf16_source", "bf16_ms", "bf16_plain_ms", "bf16_library_ms",
                 "bf16_library_device_ms", "bf16_bound_ms", "bf16_max_rel_err")
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
                                             "mbv3_launches", "slim_launches",
                                             "quant_launches", "export_launches")
           + bf16_keys if key in times[name]}}
        for name, (source, replaces) in KERNELS.items()]}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
