"""PyTorch / CUDA port of ``mobilenet_yolo_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference. Every module here names
its JAX counterpart by ``file:line`` and is held against it by the
``tests/test_torch_*.py`` parity tests. This package imports ``torch`` and
never ``jax``.

Ported so far: the serving path — ``models`` (MBv2-YOLO), ``ops`` (anchors,
boxes, decode, NMS), ``kernels`` (the hand-written NMS suppression scan)
and ``eval.detector.make_predict_fn`` — plus ``convert`` for the weights.
"""
