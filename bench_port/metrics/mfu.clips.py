"""The model's FLOPs of the clips served over the server's busy time (queue
waits excluded), over the card's TF32 peak (float32 work)."""

from bench_port.harness.readers import mfu_service as read  # noqa: F401
