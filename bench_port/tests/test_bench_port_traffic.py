"""The traffic generator: the same seed gives the same requests, another
seed another order of the same work."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from bench_port.harness.traffic import arrivals, schedule

CLIPS = {"arrival": "poisson", "rate_per_s": 35.0, "in_flight": 2, "sizes": [64, 128],
         "shares": [1, 1], "pool_frames": 1024, "offset_step": 1}
SCORE = {"arrival": "closed", "in_flight": 2, "sizes": [128], "shares": [1],
         "pool_frames": 1024, "offset_step": 128}


def _rows(traffic, seed, seconds=10.0, n=None):
    reqs = schedule(traffic, seed, seconds)
    if n is not None:
        reqs = itertools.islice(reqs, n)
    return [(r.due, r.size, r.offset) for r in reqs]


@pytest.mark.parametrize("traffic", [CLIPS, SCORE], ids=["poisson", "closed"])
def test_same_seed_same_requests_other_seed_other(traffic):
    n = None if traffic is CLIPS else 300
    big = 2**31 + 12345
    a, b, c = _rows(traffic, big, n=n), _rows(traffic, big, n=n), _rows(traffic, big + 1, n=n)
    assert a == b
    assert a != c


@pytest.mark.parametrize("seed", [1, 2**33 + 7])
def test_open_loop_work_fixed_across_seeds(seed):
    base = _rows(CLIPS, 0)
    rows = _rows(CLIPS, seed)
    assert len(rows) == len(base) == 350
    assert sorted(s for _, s, _ in rows) == sorted(s for _, s, _ in base)
    gaps = np.diff([d for d, _, _ in rows] + [10.0])
    base_gaps = np.diff([d for d, _, _ in base] + [10.0])
    np.testing.assert_allclose(np.sort(gaps), np.sort(base_gaps), rtol=1e-9)
    dues = [d for d, _, _ in rows]
    assert dues == sorted(dues) and dues[0] == 0.0 and dues[-1] < 10.0
    assert all(0 <= o <= 1024 - s for _, s, o in rows)


def test_closed_loop_shares_and_offsets():
    mixed = {**SCORE, "sizes": [64, 128], "shares": [1, 3], "offset_step": 64}
    rows = _rows(mixed, 5, n=200)
    assert sum(1 for _, s, _ in rows if s == 64) == 50
    assert all(d == 0.0 and o % 64 == 0 and o + s <= 1024 for d, s, o in rows)


def test_bursts_keep_arrivals_in_on_spells():
    bursty = {**CLIPS, "burst": {"on_s": 1.0, "off_s": 1.5}}
    due = arrivals(bursty, 3, 10.0)
    assert len(due) == round(35.0 * 4.0)
    assert all(t % 2.5 < 1.0 for t in due)
