"""The median clip latency, beside the tail (host clock)."""

from bench_port.harness.readers import latency_percentile_ms


def read(run):
    return latency_percentile_ms(run, 50, host_only=True)
