"""The server and the measured window.

One FIFO server keeps up to ``in_flight`` requests enqueued on the device.
Issuing a request copies its frames from the pinned pool into the device
buffer of a free slot on a copy stream of its own, makes the compute
stream wait for that copy, calls ``predict`` (which enqueues the work and
returns at once), enqueues the copies of ``dets``, ``keep`` (and the seg
maps) into the slot's pinned host buffers, and records an event. A request
is done when the host sees that event: its outputs are then on the host.
The host spins on the oldest slot's event, so it notices a completion
within microseconds.

Times are host-clock seconds after the window opens. A closed loop issues
while the window is open; an open loop issues each request at its due
time or as soon as a slot frees after it. After the window closes the
server finishes what was issued (an open loop: every request due in the
window), for at most ``DRAIN_S`` seconds; what is not done by then has
failed.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Callable, Iterator

import numpy as np
import torch

from bench_port.harness.traffic import Request

DRAIN_S = 60.0


class _HostEvent:
    """The CPU's stand-in for a CUDA event: work on the CPU is done when
    the call returns."""

    def record(self, stream=None):
        pass

    def query(self) -> bool:
        return True

    def synchronize(self):
        pass


class Sampler:
    """A seeded reservoir per request size: the outputs of ``k`` requests of
    that size, drawn uniformly from those done, kept for the output check.
    The largest size keeps 2, every other size 1."""

    def __init__(self, sizes: list[int], seed: int):
        largest = max(sizes)
        self.k = {s: 2 if s == largest else 1 for s in sizes}
        self.seen = {s: 0 for s in sizes}
        self.kept: dict[int, list] = {s: [] for s in sizes}
        self.rng = np.random.default_rng([seed, 4])

    def offer(self, req: Request, outputs: Callable[[], tuple]) -> None:
        s = req.size
        self.seen[s] += 1
        if len(self.kept[s]) < self.k[s]:
            self.kept[s].append((req, outputs()))
            return
        j = int(self.rng.integers(self.seen[s]))
        if j < self.k[s]:
            self.kept[s][j] = (req, outputs())

    def samples(self) -> list[tuple[Request, tuple]]:
        return [item for s in sorted(self.kept) for item in self.kept[s]]


class Server:
    def __init__(self, predict: Callable, pool: torch.Tensor, sizes: list[int],
                 in_flight: int, val_conf: float, device: torch.device):
        self.predict, self.pool, self.device = predict, pool, device
        self.cuda = device.type == "cuda"
        self.max_size = max(sizes)
        self.val_conf = torch.tensor(val_conf, dtype=torch.float32, device=device)
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self.slots = []
        for _ in range(in_flight):
            self.slots.append({
                "frames": torch.empty((self.max_size, *pool.shape[1:]), dtype=torch.uint8,
                                      device=device),
                "uploaded": self._event(), "done": self._event(), "host": None})
        self.spans = False  # record_function spans, for a traced window

    def _event(self):
        return torch.cuda.Event() if self.cuda else _HostEvent()

    def _span(self, name: str):
        return torch.profiler.record_function(name) if self.spans else contextlib.nullcontext()

    def _host_buffers(self, outputs: tuple) -> list[torch.Tensor]:
        return [torch.empty((self.max_size, *t.shape[1:]), dtype=t.dtype,
                            pin_memory=self.cuda) for t in outputs]

    def issue(self, req: Request, slot: dict, clock: Callable[[], float]) -> None:
        req.issued = clock()
        n = req.size
        with self._span("bench:issue"):
            frames = slot["frames"][:n]
            src = self.pool[req.offset:req.offset + n]
            if self.cuda:
                with torch.cuda.stream(self.copy_stream):
                    frames.copy_(src, non_blocking=True)
                    slot["uploaded"].record(self.copy_stream)
                torch.cuda.current_stream(self.device).wait_event(slot["uploaded"])
            else:
                frames.copy_(src)
            with self._span(f"bench:req{req.index}:{n}"):
                req.enq0 = clock()
                outputs = self.predict(frames, self.val_conf)
                req.enq1 = clock()
            if slot["host"] is None:
                slot["host"] = self._host_buffers(outputs)
            for host, out in zip(slot["host"], outputs):
                host[:n].copy_(out, non_blocking=self.cuda)
            slot["done"].record()
        slot["req"] = req

    @staticmethod
    def outputs(slot: dict) -> tuple:
        n = slot["req"].size
        return tuple(h[:n].numpy().copy() for h in slot["host"])

    def serve(self, requests: Iterator[Request], seconds: float, closed: bool,
              sampler: Sampler | None = None, on_tick: Callable | None = None) -> dict:
        """Run the window; returns the requests issued (``issued``) and those
        due in the window and never issued (``unissued``)."""
        t0 = time.perf_counter()

        def clock() -> float:
            return time.perf_counter() - t0

        free = deque(self.slots)
        busy: deque = deque()
        issued: list[Request] = []
        nxt = next(requests, None)
        while True:
            now = clock()
            if on_tick is not None:
                on_tick(now)
            if busy and busy[0]["done"].query():
                slot = busy.popleft()
                slot["req"].done = clock()
                if sampler is not None:
                    sampler.offer(slot["req"], lambda: self.outputs(slot))
                free.append(slot)
                continue
            open_now = now < seconds
            if nxt is not None and free and (open_now if closed else nxt.due <= now):
                slot = free.popleft()
                self.issue(nxt, slot, clock)
                busy.append(slot)
                issued.append(nxt)
                nxt = next(requests, None)
                continue
            # an open loop whose last request is done keeps ticking until
            # the window closes: the window (and a traced slice) has its length
            if not open_now and (closed or nxt is None):
                if not busy or now > seconds + DRAIN_S:
                    break
            elif not closed and now > seconds + DRAIN_S:
                break
        unissued = [] if closed else ([nxt] if nxt is not None else []) + list(requests)
        return {"issued": issued, "unissued": unissued}
