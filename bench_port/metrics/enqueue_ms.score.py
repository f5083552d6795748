"""Mean host milliseconds of the predict call, which only enqueues the work
(make_predict_fn makes no host synchronisation)."""

from bench_port.harness.readers import enqueue_ms as read  # noqa: F401
