"""The measured window lasts its length: an open loop whose last request is
done before the close keeps ticking until then, so a traced slice that ends
at the close is closed."""

from __future__ import annotations

import pytest
import torch

from bench_port.harness.cell import _SliceHook
from bench_port.harness.server import Server
from bench_port.harness.traffic import Request


class _Tracer:
    def __init__(self):
        self.calls = []

    def start(self):
        self.calls.append("start")

    def open_slice(self):
        self.calls.append("open")

    def close_slice(self):
        self.calls.append("close")


def _predict(frames, val_conf):
    n = frames.shape[0]
    return torch.zeros((n, 3, 6)), torch.zeros((n, 3), dtype=torch.bool)


@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed"])
def test_window_lasts_its_length_and_the_slice_closes(closed):
    seconds = 0.8  # the slice opens at 0.5 s (LEAD_S), after the profiler starts
    pool = torch.zeros((8, 4, 4, 3), dtype=torch.uint8)
    server = Server(_predict, pool, [2], 2, 0.3, torch.device("cpu"))
    tracer, ticks = _Tracer(), []
    hook = _SliceHook(tracer, seconds)

    def on_tick(now):
        ticks.append(now)
        hook(now)

    # an open loop's last request is due long before the close
    reqs = (Request(i, 0.01 * i, 2, 0) for i in range(3))
    window = server.serve(reqs, seconds, closed, on_tick=on_tick)
    assert max(ticks) >= seconds
    assert tracer.calls == ["start", "open", "close"] and hook.ended
    assert all(r.done == r.done for r in window["issued"])
