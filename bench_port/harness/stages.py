"""The program's own spans in a traced window: where each request's device
time goes by stage.

The port opens ``myt:<stage>`` spans while a profiler records host activity
(``mobilenet_yolo_tpu_torch.utils.profiling.span``): in each ``predict``
call ``myt:normalise``, ``myt:backbone``, ``myt:heads``, ``myt:seg_head``,
``myt:decode``, ``myt:select`` and ``myt:nms``. A kernel belongs to the
innermost ``myt:`` span that holds its launch on the launching thread (the
trace's ``correlation`` ids link launch and kernel), and to the request
whose ``bench:req`` span holds that launch, as ``trace.summarise`` counts
requests; a kernel whose launch the trace lacks goes with the kernel
before it. A program without the spans gives stages that hold nothing:
every reader below returns None.

``reduce`` takes the chrome trace's events (microseconds), as
``trace.summarise`` does, and needs no edit to it. Every reading follows
correlation ids alone, never the trace's alignment of the host's clock to
the device's, which can be off by milliseconds.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from bench_port.harness.trace import DEVICE_CATS, LAUNCH_CATS, REQ

PREFIX = "myt:"
OUTSIDE = "(no span)"
DECODE_NMS = ("myt:decode", "myt:select", "myt:nms")
NECK_HEADS = ("myt:heads", "myt:seg_head")


@dataclass
class Stages:
    # per request run whole in the slice: frames, and by the innermost myt:
    # span of each kernel (OUTSIDE: none) [device seconds, launches]
    requests: dict[int, dict] = field(default_factory=dict)
    # over those requests, by span and kernel name: [device seconds, launches]
    kernels: dict[str, dict[str, list]] = field(default_factory=dict)
    # kernels of those requests whose launch the trace lacks
    unlaunched: int = 0


def _innermost(spans: list[tuple[float, float, str]],
               points: list[tuple[float, object]]) -> dict[object, str]:
    """For each ``(t, key)`` of ``points``, the name of the innermost of
    ``spans`` (one thread's, so nested) that holds ``t``."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out: dict[object, str] = {}
    stack: list[tuple[float, float, str]] = []
    i = 0
    for t, key in sorted(points, key=lambda p: p[0]):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[key] = stack[-1][2]
    return out


def _by_thread(spans: list[dict]) -> dict[object, list[tuple[float, float, str]]]:
    out: dict[object, list] = {}
    for e in spans:
        out.setdefault(e.get("tid"), []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
    return out


def reduce(events: list[dict]) -> Stages:
    """The stages of a chrome trace's events (``Tracer``'s slice)."""
    xs = [e for e in events if e.get("ph") == "X"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    slices = [e for e in xs if e.get("name") == "bench:slice"]
    if slices:
        s0, s1 = slices[0]["ts"], slices[0]["ts"] + slices[0]["dur"]
    else:  # as trace.summarise: from the first request to the last device operation
        s0 = min(e["ts"] for e in xs if REQ.match(e.get("name", "")))
        s1 = max(e["ts"] + e["dur"] for e in device)
    annotations = [e for e in xs if e.get("cat") == "user_annotation"]
    spans = [e for e in annotations if e["name"].startswith(PREFIX)]
    threads = _by_thread(spans)
    out = Stages()

    # each kernel's launch: its request (as summarise), its innermost span
    reqs = sorted((e["ts"], e["ts"] + e["dur"], *map(int, REQ.match(e["name"]).groups()))
                  for e in annotations if REQ.match(e["name"]))
    starts = [r[0] for r in reqs]
    launches = {e["args"]["correlation"]: (e["ts"], e.get("tid")) for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    points: dict[object, list] = {}
    for corr, (ts, tid) in launches.items():
        points.setdefault(tid, []).append((ts, corr))
    stage_of: dict[object, str] = {}
    for tid, pts in points.items():
        for corr, name in _innermost(threads.get(tid, []), pts).items():
            stage_of[corr] = name

    requests: dict[int, dict] = {}
    for a, _, index, frames in reqs:
        if a >= s0:
            requests[index] = {"frames": frames, "stages": {}, "kernels": [], "end": 0.0,
                               "unlaunched": 0}
    current, stage = None, OUTSIDE
    for e in sorted((e for e in device if e.get("cat") == "kernel"), key=lambda e: e["ts"]):
        corr = e.get("args", {}).get("correlation")
        launched = corr in launches
        if launched:
            ts = launches[corr][0]
            i = bisect.bisect_right(starts, ts) - 1
            current = reqs[i][2] if i >= 0 and reqs[i][0] <= ts <= reqs[i][1] else None
            stage = stage_of.get(corr, OUTSIDE)
        if current not in requests:
            continue
        req = requests[current]
        req["kernels"].append((stage, e["name"], e["dur"] * 1e-6))
        req["end"] = max(req["end"], e["ts"] + e["dur"])
        req["unlaunched"] += not launched
    for index, req in requests.items():
        if not req["kernels"] or req["end"] > s1:
            continue
        for stage, name, dur in req["kernels"]:
            s = req["stages"].setdefault(stage, [0.0, 0])
            s[0] += dur
            s[1] += 1
            k = out.kernels.setdefault(stage, {}).setdefault(name[:120], [0.0, 0])
            k[0] += dur
            k[1] += 1
        out.unlaunched += req["unlaunched"]
        out.requests[index] = {"frames": req["frames"], "stages": req["stages"]}
    return out


def _spanned(stages: Stages | None) -> list[dict]:
    """The requests whose kernels the program's spans hold (none from a
    program without spans)."""
    if stages is None:
        return []
    return [r for r in stages.requests.values() if set(r["stages"]) - {OUTSIDE}]


def per_frame_us(stages: Stages | None, names: tuple[str, ...]) -> float | None:
    """Device microseconds a frame of the kernels launched under the spans
    ``names``, over the frames of the whole requests in the slice."""
    reqs = _spanned(stages)
    frames = sum(r["frames"] for r in reqs)
    if not frames:
        return None
    seconds = sum(r["stages"][n][0] for r in reqs for n in names if n in r["stages"])
    return seconds / frames * 1e6


def decode_nms_us(stages: Stages | None) -> float | None:
    return per_frame_us(stages, DECODE_NMS)


def neck_heads_us(stages: Stages | None) -> float | None:
    return per_frame_us(stages, NECK_HEADS)


def leaf_share(stages: Stages | None) -> float | None:
    """The share of the whole requests' kernel device time under a
    ``myt:`` span."""
    reqs = _spanned(stages)
    total = sum(s[0] for r in reqs for s in r["stages"].values())
    if total <= 0:
        return None
    leaf = sum(s[0] for r in reqs for n, s in r["stages"].items() if n != OUTSIDE)
    return 100.0 * leaf / total
