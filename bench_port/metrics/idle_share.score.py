"""The share of the traced slice in which no operation ran on the device."""

from bench_port.harness.readers import idle_share as read  # noqa: F401
