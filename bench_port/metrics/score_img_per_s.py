"""Frames scored a second: every frame whose outputs reached the host in
the window, over the window (host clock)."""

from bench_port.harness.readers import images_per_s as read  # noqa: F401
