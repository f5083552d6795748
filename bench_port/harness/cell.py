"""One run of one cell: set-up, the window, the readings, the output check.

``run_cell`` takes the device it is given; the command line
(``bench_port/run.py``) gives it the card and refuses to run without one.
Tests drive it on the CPU at a tiny size, with ``fault`` wrapping the
program's ``predict`` to break the timed path underneath.
"""

from __future__ import annotations

import gc
import math
import os
import sys
from dataclasses import dataclass
from typing import Callable

import torch

from bench_port.harness import check, flops, inputs, system
from bench_port.harness.server import DRAIN_S, Sampler, Server
from bench_port.harness.spec import Cell
from bench_port.harness.trace import LEAD_S, Tracer, TraceSummary
from bench_port.harness.traffic import Request, schedule

WARMUP_CALLS = 3
TRACE_S = 4.0
FORBIDDEN = ("jax", "jaxlib", "flax", "mobilenet_yolo_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclass
class Run:
    """What the metric files read."""
    closed: bool
    seconds: float
    setup_s: float
    precision: str
    flops_per_image: float
    launches: list
    peaks: dict | None
    requests: list[Request]
    unissued: list[Request]
    drain_s: float = DRAIN_S
    untraced_until: float = math.inf
    trace: TraceSummary | None = None

    def due_requests(self) -> list[Request]:
        return [r for r in self.requests + self.unissued if r.due < self.seconds]

    def attempted(self) -> int:
        return len(self.requests) if self.closed else len(self.due_requests())

    def failed(self) -> int:
        reqs = self.requests if self.closed else self.due_requests()
        return sum(1 for r in reqs if not r.done == r.done)


class _SliceHook:
    """Starts the profiler ``LEAD_S`` before the traced slice, opens the
    slice ``TRACE_S`` before the window closes and closes it at the close."""

    def __init__(self, tracer: Tracer, seconds: float):
        self.tracer, self.seconds = tracer, seconds
        self.open_at = max(LEAD_S, seconds - TRACE_S)
        self.started_at = math.inf
        self.opened = self.ended = False

    def __call__(self, now: float) -> None:
        if self.started_at == math.inf:
            if now >= self.open_at - LEAD_S:
                self.tracer.start()
                self.started_at = now
        elif not self.opened:
            if now >= self.open_at:
                self.tracer.open_slice()
                self.opened = True
        elif not self.ended and now >= self.seconds:
            self.tracer.close_slice()
            self.ended = True


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class _Stages:
    """Logs the process's age at each step of set-up."""

    def __init__(self, log):
        self.log = log
        self("start")

    def __call__(self, name: str) -> None:
        print(f"setup {name}: {process_age_s():.2f} s", file=self.log, flush=True)


@dataclass
class Prepared:
    """A cell set up for windows: the server warm on every request size."""
    cell: Cell
    seed: int
    device: torch.device
    device_name: str
    precision: str
    reference: object
    server: Server
    pool: torch.Tensor
    sizes: list[int]


def prepare(cell: Cell, seed: int, device: torch.device, precision: str | None = None,
            fault: Callable | None = None, log=sys.stderr) -> Prepared:
    """Set-up: weights and calibration frames from the seed, the port's
    folded predict, the frame pool, the server, and the warm-up of each
    request size. ``precision`` swaps in another serving precision of the
    program (the control); ``fault`` wraps ``predict``."""
    config, traffic = cell.config, cell.traffic
    precision = precision or config["serving"]["precision"]
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        name = torch.cuda.get_device_name(device)
        print(f"device: {name}", file=log, flush=True)
    else:
        name = "cpu"
    stages = _Stages(log)
    system.load_program()
    stages("import_program")
    reference = cell.reference()
    weights, calib, gen = inputs.model_inputs(reference, config, seed, device)
    stages("weights")
    predict = system.build_predict(config, weights, calib, device, precision, stages)
    del weights, calib
    if fault is not None:
        predict = fault(predict)
    stages("fold")
    pool = inputs.frame_pool(gen, config, int(traffic["pool_frames"]), device, pinned=cuda)
    sizes = [int(s) for s in traffic["sizes"]]
    server = Server(predict, pool, sizes, int(traffic["in_flight"]),
                    config["serving"]["val_conf"], device)
    stages("pool")
    for size in sizes:
        warm = (Request(i, 0.0, size, 0) for i in range(WARMUP_CALLS))
        server.serve(warm, 0.0, closed=False)
    stages("warmup")
    return Prepared(cell, seed, device, name, precision, reference, server, pool, sizes)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             precision: str | None = None, fault: Callable | None = None,
             log=sys.stderr) -> dict:
    """Run ``cell`` once; returns the result line's object (``checks``
    last)."""
    p = prepare(cell, seed, device, precision, fault, log)
    return measure(p, seconds, trace, log)


def measure(p: Prepared, seconds: float, trace: bool, log=sys.stderr) -> dict:
    """The window, its readings and the output check, on a prepared cell
    (which this uses up)."""
    cell, config, traffic, device = p.cell, p.cell.config, p.cell.traffic, p.device
    cuda = device.type == "cuda"
    server, reference, seed, sizes = p.server, p.reference, p.seed, p.sizes
    tracer = Tracer() if trace else None
    if tracer is not None:
        tracer.warm(device)
    table = flops.peaks(p.device_name)
    flops_img = flops.model_flops_per_image(reference, config)
    launches = flops.fused_launches(reference, config)
    if cuda:
        torch.cuda.synchronize(device)
    gc.collect()
    setup_s = process_age_s()

    closed = traffic["arrival"] == "closed"
    sampler = Sampler(sizes, seed)
    hook = _SliceHook(tracer, seconds) if tracer is not None else None
    server.spans = tracer is not None
    window = server.serve(schedule(traffic, seed, seconds), seconds, closed, sampler, hook)
    summary = tracer.stop() if tracer is not None else None
    if hook is not None and not hook.ended:
        raise RuntimeError("the window closed before the traced slice did")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")

    run = Run(closed, seconds, setup_s, p.precision, flops_img, launches, table,
              window["issued"], window["unissued"],
              untraced_until=hook.started_at if hook is not None else math.inf, trace=summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    p.server = server = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not sampler.samples():
        raise RuntimeError("no request finished: nothing to check")
    numbers = check.compare(reference, config, seed, sampler.samples(), p.pool, device)
    numbers["failed"] = run.failed()
    ok, checks = check.verdict(numbers, {**cell.limits, "failed": 0})
    dev = {"platform": "gpu" if cuda else "cpu", "kind": p.device_name, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": ok, "attempted": run.attempted(), "failed": run.failed(),
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    for key, c in checks.items():
        print(f"check {key}: {c['value']!r} limit {c['limit']!r}", file=log, flush=True)
    return result
