"""A ``torch.profiler`` trace of the window's last seconds, and what the
per-layer metrics read from it.

The profiler starts ``LEAD_S`` before the traced slice, which is one span,
``bench:slice``, from its start to the window's close. The server wraps each
``predict`` call in ``bench:req<index>:<frames>`` and each request's issue
in ``bench:issue``. A kernel belongs to the request whose ``predict`` span
holds the host call that launched it (the trace's ``correlation`` ids).
The trace is written to a temporary file, read, and removed.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import sys
import tempfile
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
REQ = re.compile(r"^bench:req(\d+):(\d+)$")
TOP = 10
LEAD_S = 0.5


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    # per request index fully inside the slice: frames, kernels [(name, dur_s)]
    requests: dict[int, dict] = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


class Tracer:
    def __init__(self):
        self.prof = None
        self.span = None
        self.summary: TraceSummary | None = None

    @staticmethod
    def _profile():
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        return torch.profiler.profile(activities=acts)

    def warm(self, device) -> None:
        """One short session during set-up, so the window pays no
        profiler start-up."""
        with self._profile():
            torch.ones(1024, device=device).sum().item()

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()

    def open_slice(self) -> None:
        self.span = torch.profiler.record_function("bench:slice")
        self.span.__enter__()

    def close_slice(self) -> None:
        self.span.__exit__(None, None, None)

    def stop(self) -> TraceSummary:
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        self.summary = summarise(events)
        return self.summary


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _short(name: str) -> str:
    return name[:120]


def summarise(events: list[dict]) -> TraceSummary:
    """Reduce a chrome trace's events (microseconds) to the slice's busy
    time, the per-request kernels, the top device operations and the idle
    gaps by what the host was doing."""
    xs = [e for e in events if e.get("ph") == "X"]
    slices = [e for e in xs if e.get("name") == "bench:slice"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if slices:
        s0, s1 = slices[0]["ts"], slices[0]["ts"] + slices[0]["dur"]
    else:
        # the profiler lost the span: the slice from the first traced request
        # to the last device operation
        print("trace: no bench:slice span; slice from the first request traced",
              file=sys.stderr)
        s0 = min(e["ts"] for e in xs if REQ.match(e.get("name", "")))
        s1 = max(e["ts"] + e["dur"] for e in device)
    clipped = [(max(e["ts"], s0), min(e["ts"] + e["dur"], s1)) for e in device]
    busy = _union([(a, b) for a, b in clipped if b > a])
    busy_us = sum(b - a for a, b in busy)

    # requests: their predict spans, and the host launch of each kernel
    spans = sorted((e["ts"], e["ts"] + e["dur"], *map(int, REQ.match(e["name"]).groups()))
                   for e in xs if e.get("cat") == "user_annotation" and REQ.match(e["name"]))
    starts = [s[0] for s in spans]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in xs
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    requests: dict[int, dict] = {}
    for a, b, index, frames in spans:
        if a >= s0:
            requests[index] = {"frames": frames, "kernels": [], "end": 0.0}
    # one compute stream runs each request's kernels after the last one's: a
    # kernel whose launch the trace lacks belongs to the request before it
    current = None
    for e in sorted((e for e in device if e.get("cat") == "kernel"), key=lambda e: e["ts"]):
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is not None:
            i = bisect.bisect_right(starts, ts) - 1
            current = spans[i][2] if i >= 0 and spans[i][0] <= ts <= spans[i][1] else None
        if current not in requests:
            continue
        req = requests[current]
        req["kernels"].append((e["name"], e["dur"] * 1e-6))
        req["end"] = max(req["end"], e["ts"] + e["dur"])
    whole = {i: r for i, r in requests.items() if r["kernels"] and r["end"] <= s1}

    totals: dict[str, float] = {}
    for e in device:
        a, b = max(e["ts"], s0), min(e["ts"] + e["dur"], s1)
        if b > a:
            totals[_short(e["name"])] = totals.get(_short(e["name"]), 0.0) + (b - a) * 1e-6
    device_ops = sorted(([n, s] for n, s in totals.items()), key=lambda x: -x[1])[:TOP]

    issue = sorted((e["ts"], e["ts"] + e["dur"]) for e in xs
                   if e.get("cat") == "user_annotation" and e["name"] == "bench:issue")
    issue_starts = [a for a, _ in issue]
    gaps: dict[str, list] = {}
    edges = [s0] + [x for ab in busy for x in ab] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        i = bisect.bisect_right(issue_starts, a) - 1
        label = ("host issuing a request (upload, predict's launches)"
                 if i >= 0 and issue[i][0] <= a <= issue[i][1]
                 else "host polling: no request due, or the device's work done")
        g = gaps.setdefault(label, [0, 0.0])
        g[0] += 1
        g[1] += (b - a) * 1e-6
    idle_gaps = sorted(([f"{k} ({n} gaps)", s] for k, (n, s) in gaps.items()),
                       key=lambda x: -x[1])[:TOP]
    return TraceSummary((s1 - s0) * 1e-6, busy_us * 1e-6, whole, device_ops, idle_gaps)
