"""PyTorch / CUDA port of ``mobilenet_yolo_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference. Every module here names
its JAX counterpart by ``file:line`` and is held against it by the
``tests/test_torch_*.py`` parity tests. This package imports ``torch`` and
never ``jax``.

Ported so far: the serving path — ``models`` (MBv2-YOLO), ``ops`` (anchors,
boxes, decode, NMS), ``kernels`` (the hand-written NMS suppression scan)
and ``eval.detector.make_predict_fn`` — plus ``convert`` for the weights;
and the training step — ``ops`` (straight-through sigmoid, CIoU/GIoU,
target assignment, losses, device augmentation), ``kernels`` (the
hand-written slot-augmentation and augment-and-compose kernels) and
``train`` (AdamW state, schedule, plain and device-geometry steps); the
BatchNorm folding and the fused-block kernels of the folded forward; and
the measurement tools — ``tools`` (training split, geometry step, stem
and augmentation probes), ``utils.profiling`` (CUDA-event timing, the
``myt:`` spans), ``kernels.stem_probe`` (the stem roofline kernel) and
``config`` (the VOC contract as plain dicts); the serving front door
(``bench``, ``cli.infer``, ``eval.evaluator``); and the input pipeline — ``data`` (record shards,
decode and augmentation, the device-geometry planner, ``Loader`` and
``WorkerLoader``, the dataset builder) and ``cli.build_dataset``; and the
training front door — ``train.loop`` (``Trainer``), ``train.checkpoints``,
``cli.train``, ``cli.eval``, ``hpo.random_search``, the one-device seam
``parallel.mesh`` and the copied ``utils`` meters, logger and TensorBoard
writer; and deployment — ``quant`` (int8 PTQ and its simulation) with
``tools.quantize``, ``tools.export`` (``torch.export`` serving programs
that carry the kernels as registered ops) and ``tools.convert_torch``
(the upstream reference's checkpoint layout).
"""
