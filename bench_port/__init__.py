"""The benchmark of the PyTorch and CUDA port (``mobilenet_yolo_tpu_torch``).

Run one cell once: ``python3 -m bench_port.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>``. See ``README.md``.
"""
