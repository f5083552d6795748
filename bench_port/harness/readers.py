"""What the metric files compute, from a run's record (``harness.cell.Run``).

Host-clock readings of a traced run take only the requests issued before
the traced slice, so the profiler's own host cost stays out of them. Each
function returns None where the run holds nothing to read.
"""

from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (q in 0-100]."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def images_per_s(run, until: float | None = None) -> float | None:
    """Frames served a second over the window (or up to ``until``): the
    frames whose outputs reached the host inside it, plus the share of the
    first request finished after it that the device served inside it (its
    service ran from the previous completion), over the window's length."""
    end = run.seconds if until is None else until
    done = sorted((r for r in run.requests if r.done == r.done), key=lambda r: r.done)
    inside = [r for r in done if r.done <= end]
    if not inside:
        return None
    frames = float(sum(r.size for r in inside))
    after = done[len(inside)] if len(done) > len(inside) else None
    if after is not None:
        start = max(inside[-1].done, after.issued)
        if after.done > start and end > start:
            frames += after.size * (end - start) / (after.done - start)
    return frames / end


def latencies_ms(run, host_only: bool = False) -> list[float]:
    """Every request due in the window, from its due time to its outputs on
    the host; one that never finished reads as the whole wait until the
    server gave up on it."""
    reqs = run.due_requests()
    if host_only:
        reqs = [r for r in reqs if r.due < run.untraced_until]
    give_up = run.seconds + run.drain_s
    return [((r.done if r.done == r.done else give_up) - r.due) * 1e3 for r in reqs]


def latency_percentile_ms(run, q: float, host_only: bool = False) -> float | None:
    lat = latencies_ms(run, host_only)
    return percentile(lat, q) if lat else None


def enqueue_ms(run) -> float | None:
    """Mean host time of the ``predict`` call, which enqueues the work."""
    reqs = [r for r in run.requests if r.issued < run.untraced_until and r.enq1 == r.enq1]
    return sum(r.enq1 - r.enq0 for r in reqs) / len(reqs) * 1e3 if reqs else None


def idle_share(run) -> float | None:
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _peak(run) -> float | None:
    from bench_port.harness.flops import PEAK_FOR
    return run.peaks[PEAK_FOR[run.precision]] if run.peaks else None


def mfu_window(run) -> float | None:
    """The model's FLOPs at the rate frames were served, over the peak."""
    peak, rate = _peak(run), images_per_s(run, run.untraced_until)
    if peak is None or rate is None:
        return None
    return 100.0 * run.flops_per_image * rate / peak


def mfu_service(run) -> float | None:
    """The model's FLOPs of the requests served, over the time the server
    spent on them (from the later of a request's issue and the previous
    request's completion, to its completion; queue waits excluded), over
    the peak."""
    peak = _peak(run)
    reqs = [r for r in run.requests if r.issued < run.untraced_until and r.done == r.done]
    if peak is None or len(reqs) < 2:
        return None
    busy = flops = 0.0
    for prev, r in zip(reqs, reqs[1:]):
        busy += r.done - max(r.issued, prev.done)
        flops += run.flops_per_image * r.size
    return 100.0 * flops / busy / peak if busy > 0 else None


def kernel_launches_per_request(run) -> float | None:
    t = run.trace
    if t is None or not t.requests:
        return None
    return sum(len(r["kernels"]) for r in t.requests.values()) / len(t.requests)


def roofline(run, patterns: tuple[str, ...]) -> float | None:
    """The least time the card could take for the launches whose kernel
    names hold one of ``patterns`` (``run.launches``, in launch order),
    over their device time, for each traced request that ran all of them."""
    t, peaks = run.trace, run.peaks
    if t is None or peaks is None:
        return None
    bound = spent = 0.0
    for req in t.requests.values():
        fused = [d for name, d in req["kernels"] if any(p in name for p in patterns)]
        if len(fused) != len(run.launches):
            continue
        bound += sum(l.bound_s(req["frames"], peaks, run.precision) for l in run.launches)
        spent += sum(fused)
    return 100.0 * bound / spent if spent > 0 else None
