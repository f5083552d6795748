"""The 95th percentile, nearest rank, over every clip due in the window,
from its due time to its outputs on the host (host clock); a clip that
never finished counts as the whole wait."""

from bench_port.harness.readers import latency_percentile_ms


def read(run):
    return latency_percentile_ms(run, 95)
