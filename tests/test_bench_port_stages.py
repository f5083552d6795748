"""The benchmark's reduction of the program's ``myt:`` spans
(``bench_port/harness/stages.py``) on a chrome trace built by hand.

Two requests run whole in the slice, a third past its close. Request 0's
spans hold one kernel each but ``myt:nms``, which holds two: one launched
under it, and one whose launch the trace lacks (it goes with the kernel
before it). Request 1 adds ``myt:seg_head`` and one kernel launched inside
``bench:req`` but outside every ``myt:`` span. A ``myt:backbone`` span on a
second thread, open over request 0's select and NMS launches, must not
take them. All times in microseconds.
"""

from __future__ import annotations

import pytest

from bench_port.harness import stages as st
from bench_port.harness.trace import summarise

SPANS_0 = [("myt:normalise", 14, 20), ("myt:backbone", 20, 50), ("myt:heads", 50, 70),
           ("myt:decode", 70, 80), ("myt:select", 80, 90), ("myt:nms", 90, 105)]
SPANS_1 = [("myt:normalise", 304, 310), ("myt:backbone", 310, 330), ("myt:heads", 330, 340),
           ("myt:seg_head", 340, 350), ("myt:decode", 350, 360), ("myt:select", 360, 370),
           ("myt:nms", 370, 390)]
SPANS_2 = [("myt:backbone", 905, 940)]
# (correlation, launch ts or None, kernel name, kernel ts, kernel dur)
KERNELS = [
    (1, 15, "elementwise_kernel", 120, 10),
    (2, 25, "fused_block_f32_kernel", 130, 40),
    (3, 55, "implicit_gemm", 170, 20),
    (4, 75, "decode_kernel", 190, 5),
    (5, 85, "sort_kernel", 195, 5),
    (6, 95, "nms_suppress_kernel", 210, 10),
    (99, None, "suppression_matrix_kernel", 220, 5),
    (18, 301, "copy_kernel", 400, 2),
    (11, 305, "elementwise_kernel", 402, 8),
    (12, 315, "fused_block_f32_kernel", 410, 40),
    (13, 335, "implicit_gemm", 450, 20),
    (14, 345, "implicit_gemm", 470, 10),
    (15, 355, "decode_kernel", 480, 4),
    (16, 365, "sort_kernel", 484, 6),
    (17, 375, "nms_suppress_kernel", 490, 10),
    (21, 910, "fused_block_f32_kernel", 990, 20),
]
COPIES = [(0, 92), (280, 23)]  # (ts, dur) of the uploads


def _x(name, ts, dur, cat, tid=1, **args):
    e = {"ph": "X", "name": name, "ts": float(ts), "dur": float(dur), "cat": cat, "tid": tid}
    if args:
        e["args"] = args
    return e


def _events(spans: bool = True, whole_slice: bool = True) -> list[dict]:
    ev = [_x("bench:slice", 0, 1000, "user_annotation")] if whole_slice else []
    ev += [_x("bench:req0:4", 10, 100, "user_annotation"),
          _x("bench:req1:2", 300, 100, "user_annotation"),
          _x("bench:req2:4", 900, 50, "user_annotation"),
          {"ph": "i", "name": "marker", "ts": 5.0}]
    if spans:
        for name, a, b in SPANS_0 + SPANS_1 + SPANS_2:
            ev.append(_x(name, a, b - a, "user_annotation"))
        ev.append(_x("myt:backbone", 80, 20, "user_annotation", tid=2))
    for corr, launch, name, ts, dur in KERNELS:
        if launch is not None:
            ev.append(_x("cudaLaunchKernel", launch, 1, "cuda_runtime", correlation=corr))
        ev.append(_x(name, ts, dur, "kernel", tid=7, correlation=corr))
    for ts, dur in COPIES:
        ev.append(_x("Memcpy HtoD (Pinned -> Device)", ts, dur, "gpu_memcpy", tid=8))
    return ev


def test_stages_split_each_requests_device_time_by_its_innermost_span():
    got = st.reduce(_events())
    assert set(got.requests) == {0, 1}  # request 2 ends past the slice's close
    want0 = {"myt:normalise": (10, 1), "myt:backbone": (40, 1), "myt:heads": (20, 1),
             "myt:decode": (5, 1), "myt:select": (5, 1), "myt:nms": (15, 2)}
    want1 = {st.OUTSIDE: (2, 1), "myt:normalise": (8, 1), "myt:backbone": (40, 1),
             "myt:heads": (20, 1), "myt:seg_head": (10, 1), "myt:decode": (4, 1),
             "myt:select": (6, 1), "myt:nms": (10, 1)}
    for index, frames, want in ((0, 4, want0), (1, 2, want1)):
        req = got.requests[index]
        assert req["frames"] == frames
        assert set(req["stages"]) == set(want)
        for name, (us, n) in want.items():
            assert req["stages"][name][0] == pytest.approx(us * 1e-6, abs=1e-12), name
            assert req["stages"][name][1] == n, name
    assert got.unlaunched == 1
    nms = got.kernels["myt:nms"]
    assert nms["nms_suppress_kernel"] == [pytest.approx(20e-6), 2]
    assert nms["suppression_matrix_kernel"] == [pytest.approx(5e-6), 1]
    assert got.kernels["myt:backbone"] == {"fused_block_f32_kernel": [pytest.approx(80e-6), 2]}


def test_stage_readers():
    got = st.reduce(_events())
    assert st.decode_nms_us(got) == pytest.approx((25 + 20) / 6)
    assert st.neck_heads_us(got) == pytest.approx((20 + 30) / 6)
    assert st.leaf_share(got) == pytest.approx(100.0 * 193 / 195)


def test_a_program_without_spans_reads_nothing():
    bare = st.reduce(_events(spans=False))
    assert set(bare.kernels) == {st.OUTSIDE}
    for reader in (st.decode_nms_us, st.neck_heads_us, st.leaf_share):
        assert reader(bare) is None
        assert reader(None) is None


def test_summarise_is_unmoved_by_the_spans():
    """The existing reduction reads the same from the trace with the
    program's spans as without them, and counts the same requests and
    launches as the stages."""
    with_spans, bare = summarise(_events()), summarise(_events(spans=False))
    assert with_spans == bare
    assert with_spans.window_s == pytest.approx(1e-3)
    assert with_spans.busy_s == pytest.approx(320e-6)
    assert {i: len(r["kernels"]) for i, r in with_spans.requests.items()} == {0: 7, 1: 8}
    stages = st.reduce(_events())
    for index, req in with_spans.requests.items():
        assert sum(n for _, n in stages.requests[index]["stages"].values()) == len(req["kernels"])
    assert [label for label, _ in with_spans.idle_gaps] == [
        "host polling: no request due, or the device's work done (5 gaps)"]


def test_without_the_slice_span_the_stages_take_summarise_s_slice():
    """A trace that lost ``bench:slice`` runs from the first request to the
    last device operation in both reductions, so request 2 is whole too."""
    events = _events(whole_slice=False)
    got = st.reduce(events)
    assert set(got.requests) == set(summarise(events).requests) == {0, 1, 2}
    assert got.requests[2] == {"frames": 4, "stages": {"myt:backbone": [pytest.approx(20e-6), 1]}}
