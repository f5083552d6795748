"""Kernel launches in the traced slice per request that ran whole in it."""

from bench_port.harness.readers import kernel_launches_per_request as read  # noqa: F401
