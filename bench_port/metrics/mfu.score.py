"""The model's convolution and matmul FLOPs at the frames-a-second served,
over the card's TF32 peak (float32 work)."""

from bench_port.harness.readers import mfu_window as read  # noqa: F401
